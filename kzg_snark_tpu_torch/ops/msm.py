"""Multi-scalar multiplication and KZG commit on PyTorch tensors.

Counterpart of ``kzg_snark_tpu/ops/msm.py``.  The JAX ``MsmContext`` picked
a bit-serial path (n <= 256), a scan path (n < 2048, kernel K9) or the
fused bucket kernel; the port sends every size to the bucket kernel
(``ops/msm_kernel.py``).
"""

from __future__ import annotations

import functools

import torch

from .fr import canonical_device, fr_backend
from .limbs import ints_to_words, to_tensor
from .msm_kernel import fused_msm


class MsmContext:
    """Pippenger MSM over one curve's G1 on one device."""

    def __init__(self, curve_type: str = "bn254", device="cpu"):
        self.curve_type = curve_type
        self.device = canonical_device(device)
        self.fused = fused_msm(curve_type, self.device)
        self.curve = self.fused.curve
        self.scalar_backend = fr_backend(curve_type, self.device)

    def msm(self, points: torch.Tensor, scalars: torch.Tensor,
            complete: bool = False) -> torch.Tensor:
        """sum_i scalars[i] points[i] -> (3, 8, 1) Jacobian.

        points: (3, 8, N) with Z = 1 (affine, never the identity).
        scalars: (8, N) canonical (non-Montgomery) limbs, or (k, 8, N)
            for k MSMs over the same points -> (3, 8, k).
        complete: the default incomplete bucket add is sound only for a
            duplicate-free, unstructured basis (SRS powers of a random tau,
            ``random_point_basis``); pass True for structured bases.
        """
        return self.fused.msm(points, scalars, complete)

    def scalars_to_limbs(self, scalar_ints) -> torch.Tensor:
        """Canonical ints -> (8, N) int32 limbs on the device."""
        r = self.scalar_backend.modulus
        return to_tensor(ints_to_words([int(s) % r for s in scalar_ints]),
                         self.device)


@functools.lru_cache(maxsize=None)
def _context(curve_type: str, device: torch.device) -> MsmContext:
    return MsmContext(curve_type, device)


def msm_context(curve_type: str = "bn254", device="cpu") -> MsmContext:
    return _context(curve_type, canonical_device(device))


def affine_to_host(kzg, affine):
    """An affine int pair (or None) -> the host projective tuple the
    transcript serializes: (x, y, 1), or the identity."""
    if affine is None:
        return kzg.Z1
    Fp = type(kzg.G1[0])
    return (Fp(affine[0]), Fp(affine[1]), Fp(1))


def commit(kzg, ck, poly) -> tuple:
    """KZG commitment on the card: MSM of the polynomial's coefficients
    against the device SRS, returned as the canonical host tuple."""
    from .srs import DeviceSRS

    if not isinstance(ck, DeviceSRS):
        raise TypeError("the cuda backend needs a DeviceSRS commitment key")
    coeffs = poly.list()
    if not coeffs:
        return kzg.Z1
    ctx = msm_context(kzg.curve_type, ck.device)
    pts = ck.points[..., :len(coeffs)]
    result = ctx.msm(pts, ctx.scalars_to_limbs([int(c) for c in coeffs]))
    return affine_to_host(kzg, ctx.curve.to_affine_ints(result)[0])
