"""Multi-scalar multiplication and KZG commit on PyTorch tensors.

Counterpart of ``kzg_snark_tpu/ops/msm.py``.  ``MsmContext.msm`` routes on
the number of points n as the JAX ``MsmContext`` does:

* n >= 2048: the sorted-bucket kernels (``ops/msm_kernel.py``: the
  schedule's ``msm_digits``, ``msm_sort`` and ``msm_bucket_offsets``,
  then ``msm_accumulate``, K8, and ``msm_reduce``);
* n <= 256: bit-serial double-and-add (the JAX ``_small_msm_core``, its
  representatives), the whole ladder and its halving tree in one
  ``g1_ladder`` launch (K7 with K6's add);
* otherwise: the scan Pippenger (``_scan_msm``, the JAX ``_msm_core``):
  8-bit windows, one complete mixed add (K9) of width W * lanes per step
  between a gather and a scatter of the (W, 256, lanes) bucket table, then
  the lane merge and the suffix ladder on K6, and the Horner fold in the
  bucket route's one Horner launch (``msm_kernel.reduce_horner``).

``commit`` pads the SRS slice to a power of two (``DeviceSRS.slice_pow2``)
as the JAX ``commit`` does, so a commit takes the same route on the same
length in both packages.

Points are (3, L, n) over the curve's base field (L = 8 at BN254, 12 at
BLS12-381); scalars are (8, n) canonical Fr limbs on both curves.
``complete=None`` reads ``KZG_TPU_COMPLETE_ADD`` at call time, as the JAX
``FusedMsm._resolve_complete`` does (``ops/msm_kernel.resolve_complete``).
A context made while ``KZG_TPU_CHECKED`` is on (``msm_context`` keys its
cache by the flag) computes over the checked Fq backend and validates each
MSM's result.
"""

from __future__ import annotations

import functools

import torch

from . import cuda_fr
from .fr import canonical_device, checked_enabled, fr_backend
from .g1 import CurveOps, generator
from .limbs import SCALAR_LIMBS, ints_to_words, to_tensor
from .msm_grouped import grouped_table, msm_grouped_prepared
from .msm_kernel import fused_msm, reduce_horner

SMALL_THRESHOLD = cuda_fr.LADDER_POINTS
FUSED_THRESHOLD = 2048
SCAN_WINDOW_BITS = 8


def halve_sum_last(curve: CurveOps, pts: torch.Tensor) -> torch.Tensor:
    """Tree sum along the last (power-of-two) axis: (3, L, ..., n) ->
    (3, L, ...)."""
    n = pts.shape[-1]
    while n > 1:
        half = n // 2
        pts = curve.add(pts[..., :half], pts[..., half:])
        n = half
    return pts[..., 0]


def suffix_ladder(curve: CurveOps, pts: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sums along the last (power-of-two) axis by a
    Hillis-Steele ladder with identity (all-zero) fill."""
    n = pts.shape[-1]
    shift = 1
    while shift < n:
        fill = torch.zeros_like(pts[..., :shift])
        pts = curve.add(pts, torch.cat([pts[..., shift:], fill], dim=-1))
        shift *= 2
    return pts


def _choose_lanes(n: int) -> int:
    """The JAX ``MsmContext._choose_lanes``."""
    if n >= 32768:
        return 128
    if n >= 4096:
        return 64
    return 32


def _scan_msm(curve: CurveOps, points: torch.Tensor, scalars: torch.Tensor,
              gen: torch.Tensor) -> torch.Tensor:
    """Scan Pippenger of one scalar set: points (3, L, n) with Z = 1,
    scalars (8, n) canonical -> (3, L, 1)."""
    c = SCAN_WINDOW_BITS
    L, n = points.shape[1], points.shape[-1]
    lanes = _choose_lanes(n)
    steps = -(-n // lanes)
    pad = steps * lanes - n
    if pad:       # the generator with digit 0: lands in the dropped bucket
        points = torch.cat([points, gen.expand(3, L, pad)], dim=-1)
    pts = points.reshape(3, L, steps, lanes)
    words = cuda_fr._wide(scalars)
    if pad:
        words = torch.cat([words, torch.zeros_like(words[:, :pad])], dim=1)
    per_word = 32 // c
    dig = torch.stack([(words[w // per_word] >> (c * (w % per_word)))
                       & ((1 << c) - 1)
                       for w in range(SCALAR_LIMBS * per_word)])  # (W, n)
    W, B = dig.shape[0], 1 << c
    dig = dig.reshape(W, steps, lanes)

    buckets = curve.identity((W * B * lanes,)).contiguous()
    w_base = (torch.arange(W, device=dig.device) * B)[:, None]
    lane = torch.arange(lanes, device=dig.device)[None, :]
    for s in range(steps):
        flat = ((w_base + dig[:, s, :]) * lanes + lane).reshape(-1)
        cur = buckets[:, :, flat].reshape(3, L, W, lanes)
        new = curve.add_mixed(cur, pts[0, :, s][:, None, :],
                              pts[1, :, s][:, None, :])
        buckets[:, :, flat] = new.reshape(3, L, W * lanes)
    buckets = buckets.reshape(3, L, W, B, lanes)
    buckets[2, :, :, 0, :] = 0                   # drop bucket 0

    merged = halve_sum_last(curve, buckets)               # (3, L, W, B)
    suffix = suffix_ladder(curve, merged)
    suffix[2, :, :, 0] = 0                       # exclude the j = 0 term
    window_sums = halve_sum_last(curve, suffix)           # (3, L, W)
    # acc = 2^c acc + S_w from the top window: one piece a window.
    return reduce_horner(curve.f.consts, window_sums.contiguous(), 1, W, c)


class MsmContext:
    """Pippenger MSM over one curve's G1 on one device."""

    def __init__(self, curve_type: str = "bn254", device="cuda"):
        self.curve_type = curve_type
        self.device = canonical_device(device)
        self.fused = fused_msm(curve_type, self.device)
        self.curve = self.fused.curve
        self.scalar_backend = fr_backend(curve_type, self.device)
        gx, gy = generator(curve_type)
        self._gen = self.curve.from_affine_ints([gx], [gy])

    @staticmethod
    def route(n: int) -> str:
        """"bucket", "small" or "scan": the JAX package's choice at n."""
        if n >= FUSED_THRESHOLD:
            return "bucket"
        if n <= SMALL_THRESHOLD:
            return "small"
        return "scan"

    def msm(self, points: torch.Tensor, scalars: torch.Tensor,
            complete: bool | None = None) -> torch.Tensor:
        """sum_i scalars[i] points[i] -> (3, L, 1) Jacobian.

        points: (3, L, N) with Z = 1 (affine, never the identity).
        scalars: (8, N) canonical (non-Montgomery) limbs, or (k, 8, N)
            for k MSMs over the same points -> (3, L, k).
        complete: the bucket route's incomplete add (None with
            KZG_TPU_COMPLETE_ADD unset) is sound only for a
            duplicate-free, unstructured basis (SRS powers of a random
            tau, ``random_point_basis``); pass True, or set the variable,
            for structured bases.  The other routes always use complete
            adds.
        """
        route = self.route(points.shape[-1])
        if route == "bucket":
            out = self.fused.msm(points, scalars, complete)
        else:
            sets = scalars if scalars.dim() == 3 else scalars[None]
            if route == "small":
                out = cuda_fr.g1_ladder(self.curve.f.consts,
                                        points.contiguous(),
                                        sets.contiguous())
            else:
                out = torch.cat([_scan_msm(self.curve, points, s, self._gen)
                                 for s in sets], dim=-1)
        return self.curve.checked_output(out, "msm")

    def msm_grouped(self, points: torch.Tensor, scalars: torch.Tensor,
                    complete: bool | None = None) -> torch.Tensor:
        """G MSMs of n points, each group with its own points and k scalar
        sets, in four launches and no host wait (``ops/msm_grouped.py``):
        points (3, L, G n) with Z = 1, never the identity (group g's at
        [g n, (g + 1) n)); scalars (G, k, 8, n) canonical -> (3, L, G, k)
        Jacobian.  ``complete`` as ``msm``: pass True for points computed
        on the card."""
        return self.msm_grouped_prepared(grouped_table(points), scalars,
                                         complete)

    def msm_grouped_prepared(self, table: torch.Tensor,
                             scalars: torch.Tensor,
                             complete: bool | None = None,
                             c: int | None = None) -> torch.Tensor:
        """``msm_grouped`` over the (G n, 2 L) table of ``grouped_table``,
        which a fixed basis keeps; ``c``, the window width, by default
        ``msm_grouped.window_bits`` of the group's n."""
        out = msm_grouped_prepared(self.curve.f.consts, table, scalars,
                                   self.fused.total_bits, complete, c)
        return self.curve.checked_output(out, "msm")

    def scalars_to_limbs(self, scalar_ints) -> torch.Tensor:
        """Canonical ints -> (8, N) int32 limbs on the device."""
        r = self.scalar_backend.modulus
        return to_tensor(ints_to_words([int(s) % r for s in scalar_ints]),
                         self.device)

    def msm_ints(self, affine_points: list, scalar_ints: list
                 ) -> torch.Tensor:
        """Host affine int pairs and int scalars -> the device MSM."""
        pts = self.curve.from_affine_ints([p[0] for p in affine_points],
                                          [p[1] for p in affine_points])
        return self.msm(pts, self.scalars_to_limbs(scalar_ints))


@functools.lru_cache(maxsize=None)
def _context(curve_type: str, device: torch.device, checked: bool
             ) -> MsmContext:
    return MsmContext(curve_type, device)


def msm_context(curve_type: str = "bn254", device="cuda") -> MsmContext:
    """The cached context of (curve, device), checked while
    KZG_TPU_CHECKED is on."""
    return _context(curve_type, canonical_device(device), checked_enabled())


def affine_to_host(kzg, affine):
    """An affine int pair (or None) -> the host projective tuple the
    transcript serializes: (x, y, 1), or the identity."""
    if affine is None:
        return kzg.Z1
    Fp = type(kzg.G1[0])
    return (Fp(affine[0]), Fp(affine[1]), Fp(1))


def commit(kzg, ck, poly) -> tuple:
    """KZG commitment on the card: MSM of the polynomial's coefficients
    against the device SRS sliced to the next power of two, returned as the
    canonical host tuple."""
    from .srs import DeviceSRS

    if not isinstance(ck, DeviceSRS):
        raise TypeError("the cuda backend needs a DeviceSRS commitment key")
    coeffs = poly.list()
    if not coeffs:
        return kzg.Z1
    ctx = msm_context(kzg.curve_type, ck.device)
    pts = ck.slice_pow2(len(coeffs))
    ints = [int(c) for c in coeffs] + [0] * (pts.shape[-1] - len(coeffs))
    result = ctx.msm(pts, ctx.scalars_to_limbs(ints))
    return affine_to_host(kzg, ctx.curve.to_affine_ints(result)[0])
