"""Batched short-Weierstrass (a = 0) curve arithmetic on PyTorch tensors.

Counterpart of ``kzg_snark_tpu/ops/g1.py`` ``CurveOps``.  A batch of points
is an int32 tensor of shape (3, L, ...): Jacobian (X, Y, Z) over the L Fq
limbs in Montgomery form (L = 8 at BN254, 12 at BLS12-381), the identity
encoded as Z = 0.  ``add`` and ``double``
dispatch as ``g1.py:77-94`` does: to the K6 / K7 kernels for CUDA tensors
and to their plain versions for CPU tensors.  The formulas are those of
``ops/regcurve.py``, so every representative equals the JAX package's.

``add_mixed`` (p + an affine q, complete madd-2007-bl) goes to the K9
kernel for CUDA tensors and its plain version for CPU tensors, and returns
the representative of the JAX ``add_mixed``.  ``scale`` and
``scale_const`` (the JAX ``g1.py:247-268``) run the double-and-add ladder
in one ``g1_ladder`` launch, one scalar for every point, with the JAX
representatives.

Over a checked Fq backend (``KZG_TPU_CHECKED``, ``ops/fr.py``) ``add``,
``double``, ``add_mixed`` and ``scale`` validate every output coordinate
(``validate_canonical``, under ``"g1.<op>"``): K6, K7, K9 and the ladder.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.build import count_sync
from ..utils.profiling import span
from . import cuda_fr
from .fr import CheckedFieldBackend, FieldBackend, fq_backend, \
    validate_canonical
from .limbs import to_tensor


class CurveOps:
    """Jacobian ops over one base field on one device."""

    def __init__(self, backend: FieldBackend):
        self.f = backend
        self.num_limbs = backend.num_limbs
        self.checked = isinstance(backend, CheckedFieldBackend)

    def checked_output(self, pts: torch.Tensor, op: str) -> torch.Tensor:
        """Validate every coordinate of a kernel's output when checked."""
        if self.checked:
            validate_canonical(self.f, pts.transpose(0, 1), f"g1.{op}")
        return pts

    # -- constructors ---------------------------------------------------
    def _ones(self, batch_shape) -> torch.Tensor:
        L = self.num_limbs
        col = self.f.one_mont.reshape((L,) + (1,) * len(batch_shape))
        return col.expand((L,) + tuple(batch_shape))

    def identity(self, batch_shape=(1,)) -> torch.Tensor:
        x = self._ones(batch_shape)
        return torch.stack([x, x, torch.zeros_like(x)])

    def from_affine_ints(self, xs, ys) -> torch.Tensor:
        """Host ints -> (3, L, N) Jacobian with Z = 1."""
        x = self.f.from_ints(xs)
        y = self.f.from_ints(ys)
        return torch.stack([x, y, self._ones(x.shape[1:])])

    def to_affine_ints(self, pts: torch.Tensor) -> list:
        """(3, L, ...) -> list of (x, y) int tuples, None for the identity:
        three waits for the card (x, y and which points are the
        identity)."""
        with span("g1.to_affine"):
            f = self.f
            flat = pts.reshape(3, self.num_limbs, -1)
            X, Y, Z = flat[0], flat[1], flat[2]
            zinv = f.inv(Z)
            zinv2 = f.mul(zinv, zinv)
            ax = f.to_ints(f.mul(X, zinv2))
            ay = f.to_ints(f.mul(Y, f.mul(zinv2, zinv)))
            count_sync("g1.to_affine_ints")
            inf = f.is_zero(Z).cpu().tolist()
        return [None if inf[i] else (ax[i], ay[i]) for i in range(len(ax))]

    def is_identity(self, pts: torch.Tensor) -> torch.Tensor:
        return self.f.is_zero(pts[2])

    # -- group law (K6 / K7) ----------------------------------------------
    def _flat(self, pts: torch.Tensor) -> torch.Tensor:
        return pts.reshape(3, self.num_limbs, -1).contiguous()

    def add(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """Complete Jacobian add; batches broadcast against each other."""
        shape = torch.broadcast_shapes(p.shape, q.shape)
        out = cuda_fr.g1_add(self.f.consts, self._flat(p.expand(shape)),
                             self._flat(q.expand(shape)))
        return self.checked_output(out.reshape(shape), "add")

    def double(self, pts: torch.Tensor) -> torch.Tensor:
        out = cuda_fr.g1_double(self.f.consts, self._flat(pts))
        return self.checked_output(out.reshape(pts.shape), "double")

    def add_mixed(self, p: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor
                  ) -> torch.Tensor:
        """Complete p + (qx, qy, 1) (K9); q finite, broadcast against p's
        batch.  A q that varies only along p's trailing batch dims (one
        point, or one per lane) is passed as a small table with a column
        period, never expanded."""
        L = self.num_limbs
        batch = p.shape[2:]
        qb = list(qx.shape[1:])
        while qb and qb[0] == 1:
            qb.pop(0)
        if tuple(qb) == tuple(batch[len(batch) - len(qb):]):
            qx = qx.reshape(L, -1)
            qy = qy.reshape(L, -1)
        else:
            qx = qx.expand((L,) + batch).reshape(L, -1)
            qy = qy.expand((L,) + batch).reshape(L, -1)
        out = cuda_fr.g1_add_mixed(self.f.consts, self._flat(p),
                                   qx.contiguous(), qy.contiguous())
        return self.checked_output(out.reshape(p.shape), "add_mixed")

    # -- scalar multiplication (K7 and K6 as the ladder) ------------------
    def scale(self, pts: torch.Tensor, scalar_bits) -> torch.Tensor:
        """Every point times the scalar whose bits, least significant first,
        are ``scalar_bits`` (any length, shared by all points): the JAX
        ``scale``.  One ``g1_ladder`` launch with one scalar row of column
        period 1, never expanded to the points."""
        bits = torch.as_tensor(scalar_bits).reshape(-1).tolist()
        words = [0] * max(1, -(-len(bits) // 32))
        for i, b in enumerate(bits):
            words[i // 32] |= (int(b) & 1) << (i % 32)
        sc = to_tensor(np.array(words, dtype=np.uint32).reshape(1, -1, 1),
                       pts.device)
        out = cuda_fr.g1_ladder(self.f.consts, self._flat(pts), sc,
                                tree=False)
        return self.checked_output(out.reshape(pts.shape), "scale")

    def scale_const(self, pts: torch.Tensor, k: int) -> torch.Tensor:
        """Scalar multiple by a Python int k >= 0 (the JAX
        ``scale_const``)."""
        if k == 0:
            return self.identity(tuple(pts.shape[2:]))
        return self.scale(pts, [(k >> i) & 1 for i in range(k.bit_length())])

    # -- reductions -----------------------------------------------------
    def tree_sum(self, pts: torch.Tensor) -> torch.Tensor:
        """Sum a (3, L, ..., N) batch along the last axis -> (3, L, ..., 1)
        by a padded halving tree."""
        n = pts.shape[-1]
        while n > 1:
            if n % 2:
                pad = self.identity(tuple(pts.shape[2:-1]) + (1,))
                pts = torch.cat([pts, pad], dim=-1)
                n += 1
            half = n // 2
            pts = self.add(pts[..., :half], pts[..., half:])
            n = half
        return pts

    # -- validation -----------------------------------------------------
    def on_curve(self, pts: torch.Tensor, b_int: int) -> torch.Tensor:
        """Jacobian curve membership: Y^2 == X^3 + b Z^6 (or identity)."""
        f = self.f
        X, Y, Z = pts[0], pts[1], pts[2]
        lhs = f.square(Y)
        z2 = f.square(Z)
        z6 = f.mul(f.square(z2), z2)
        rhs = f.add(f.mul(f.square(X), X), f.mul(f.scalar(b_int), z6))
        return f.equal(lhs, rhs) | f.is_zero(Z)


def curve_ops(curve_type: str = "bn254", device="cuda") -> CurveOps:
    return CurveOps(fq_backend(curve_type, device))


def generator(curve_type: str) -> tuple[int, int]:
    """The curve's G1 generator, affine (x, y)."""
    from .. import constants as C
    return C.BN254_G1 if curve_type == "bn254" else C.BLS12_381_G1
