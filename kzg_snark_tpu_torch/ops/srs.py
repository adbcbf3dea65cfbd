"""Structured reference string on the device.

Counterpart of ``kzg_snark_tpu/ops/srs.py``: ``DeviceSRS`` holds
[G1, tau G1, ..., tau^d G1] as a (3, L, d+1) tensor with Z = 1 (L = 8 at
BN254, 12 at BLS12-381), and
``setup_g1_powers`` builds it by a windowed fixed-base method: a table
T[j, v] = v 2^(c j) G of W x 2^c points (``g1_fixed_base_table``, one
launch of ``csrc/srs_kernels.cu``: K7 and K6 as this build uses them),
then every tau^i G is a sum of W table entries, one complete add (K6) per
window over the whole batch.  The JAX package gathered the entries
through a one-hot matmul to dodge a TPU fault; here a plain index gather
does it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.build import check, count_launch, cuda_lib
from . import cuda_fr
from .benchpoints import normalize_points
from .fr import canonical_device
from .limbs import SCALAR_LIMBS, FieldConsts, ints_to_words
from .msm import msm_context


class DeviceSRS:
    """Device-resident [G1, tau G1, ..., tau^d G1] (3, L, d+1), Z = 1."""

    def __init__(self, curve_type: str, points: torch.Tensor):
        self.curve_type = curve_type
        self.points = points
        self.device = canonical_device(points.device)
        self._curve = msm_context(curve_type, self.device).curve

    def __len__(self) -> int:
        return int(self.points.shape[-1])

    def slice_pow2(self, count: int) -> torch.Tensor:
        """The first ``count`` points, extended to the next power of two
        when the SRS holds that many (the JAX ``DeviceSRS.slice_pow2``)."""
        n = 1
        while n < count:
            n *= 2
        n = min(n, len(self))
        return self.points[..., :max(n, count)]

    def affine(self, i: int):
        """Host affine ints (x, y) of entry i, or None for the identity."""
        return self._curve.to_affine_ints(self.points[..., i:i + 1])[0]

    def __getitem__(self, i: int):
        """Host projective tuple view (x, y, 1), cached after the first
        full transfer."""
        if not hasattr(self, "_host_cache"):
            from .host.field import base_field
            Fp = base_field(self.curve_type)
            self._host_cache = [
                (Fp(a[0]), Fp(a[1]), Fp(1)) if a is not None else
                (Fp(1), Fp(1), Fp(0))
                for a in self._curve.to_affine_ints(self.points)]
        return self._host_cache[i]


def fixed_base_table_plain(fc: FieldConsts, base: torch.Tensor,
                           window_bits: int, windows: int) -> torch.Tensor:
    """T[:, :, j, v] = v 2^(c j) base for j < W, v < 2^c: (3, L, W, 2^c),
    base (3, L, 1).

    Window bases by c doublings each; the rows by doubling concatenation,
    T[:, v + 2^k] = T[:, v] + T[:, 2^k] (the K7 and K6 plain versions)."""
    bases = [base]
    for _ in range(windows - 1):
        b = bases[-1]
        for _ in range(window_bits):
            b = cuda_fr.g1_double_plain(fc, b)
        bases.append(b)
    bases = torch.cat(bases, dim=-1)                        # (3, L, W)
    one = fc.tensors(base.device)["one"].expand(fc.num_limbs, windows)
    ident = torch.stack([one, one, torch.zeros_like(one)])
    rows = torch.stack([ident, bases], dim=-1)
    while rows.shape[-1] < (1 << window_bits):
        count = rows.shape[-1]
        step = cuda_fr.g1_double_plain(
            fc, rows[..., count // 2:count // 2 + 1])      # count * b
        rows = torch.cat([rows, cuda_fr.g1_add_plain(
            fc, rows, step.expand(rows.shape))], dim=-1)
    return rows


def g1_fixed_base_table(fc: FieldConsts, base: torch.Tensor,
                        window_bits: int, windows: int) -> torch.Tensor:
    """The fixed-base table (3, L, W, 2^c) of base (3, L, 1) in one launch
    (``csrc/srs_kernels.cu``), equal word for word to
    ``fixed_base_table_plain``, which CPU tensors take."""
    if cuda_fr._on_cpu(base):
        return fixed_base_table_plain(fc, base, window_bits, windows)
    cuda_fr._require_cuda("g1_fixed_base_table", base)
    L = fc.num_limbs
    if base.shape != (3, L, 1):
        raise ValueError(f"g1_fixed_base_table: expected a (3, {L}, 1) "
                         f"base, got {tuple(base.shape)}")
    table = torch.empty((3, L, windows, 1 << window_bits),
                        dtype=torch.int32, device=base.device)
    count_launch("g1_fixed_base_table", limbs=L)
    check(cuda_lib().kzg_g1_fixed_base_table(
        base.data_ptr(), table.data_ptr(), windows, window_bits, fc.ptr,
        cuda_fr._stream(base)), "g1_fixed_base_table")
    return table


def setup_g1_powers(kzg, tau: int, max_degree: int, window_bits: int = 8,
                    device="cuda") -> DeviceSRS:
    """The device SRS [tau^i G1] for i <= max_degree."""
    ctx = msm_context(kzg.curve_type, device)
    curve = ctx.curve
    r = kzg.curve_order
    if tau % r == 0:
        raise ValueError("tau must be nonzero mod the curve order")
    n = max_degree + 1
    powers = [1] * n
    acc = 1
    for i in range(1, n):
        acc = (acc * tau) % r
        powers[i] = acc

    c = window_bits
    windows = -(-r.bit_length() // c)
    words = ints_to_words(powers).astype(np.uint64)        # (8, n) scalars
    dig = np.zeros((windows, n), dtype=np.int64)
    for j in range(windows):
        bit = c * j
        li, sh = bit >> 5, bit & 31
        v = words[li] >> np.uint64(sh)
        if sh + c > 32 and li + 1 < SCALAR_LIMBS:
            v = v | (words[li + 1] << np.uint64(32 - sh))
        dig[j] = (v & np.uint64((1 << c) - 1)).astype(np.int64)

    g1 = kzg.G1
    base = curve.from_affine_ints([int(g1[0])], [int(g1[1])])
    table = g1_fixed_base_table(curve.f.consts, base.contiguous(), c,
                                windows)                  # (3, L, W, 2^c)
    digits = torch.from_numpy(dig).to(ctx.device)
    acc_pts = curve.identity((n,)).contiguous()
    for j in range(windows):
        picked = table[:, :, j, :][:, :, digits[j]]        # (3, L, n)
        acc_pts = curve.add(acc_pts, picked)
    return DeviceSRS(kzg.curve_type, normalize_points(curve.f, acc_pts))
