"""The NTT pass kernel (K2-K5 replacement) and the staged transform.

Counterpart of ``kzg_snark_tpu/ops/ntt_stage.py``, whose four stage
kernels ran one or two stages a launch.  Here one kernel, ``ntt_pass``
(``csrc/ntt_kernels.cu``), runs the stages s0 .. s0 + g - 1 of a transform
on tiles of at most 2^t elements held in shared memory, t =
``tile_bits(n)`` (``ntt_tile_bits`` of ``csrc/ntt.cuh``: at 2^14..2^18 the
tile measured fastest at that size, elsewhere 10 bits).
``staged_transform`` runs the plan ``pass_plan``: g = min(t, stages left)
a pass, so a transform of n = 2^k is ceil(k / t) launches.  Input is
bit-reversed, output in natural order; values are exact, so any plan gives
equal output.  The plain
version ``ntt_pass_plain`` runs the same stages one ``radix2_plain`` each.

``fr_butterfly`` (K10, replaces ``pallas_fr.py`` ``_butterfly_call``) is
the stage combine of the scan-mode transform (``ops/ntt.py``): pairs
aligned by the caller, ``mask ? xl - tw xu : xl + tw xu`` elementwise.

Each wrapper runs its plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from ..utils.build import check, count_launch, cuda_lib
from . import cuda_fr
from .limbs import FieldConsts


def radix2_plain(fc: FieldConsts, x: torch.Tensor, tw: torch.Tensor,
                 span: int) -> torch.Tensor:
    """One stage of span ``span`` on (L, n); tw is the (L, n/2) table."""
    f = cuda_fr.PlainField(fc)
    L, n = x.shape
    stride = n // (2 * span)
    w = tw[:, 0:span * stride:stride]                       # (L, span)
    v = x.reshape(L, n // (2 * span), 2, span)
    prod = f.mul(v[:, :, 1], w[:, None, :])
    lo = v[:, :, 0]
    return torch.stack([f.add(lo, prod), f.sub(lo, prod)], dim=2).reshape(
        L, n)


def ntt_pass_plain(fc: FieldConsts, x: torch.Tensor, tw: torch.Tensor,
                   s0: int, g: int) -> torch.Tensor:
    """Stages s0 .. s0 + g - 1 (spans 2^s0 .. 2^(s0+g-1)) on (L, n)."""
    for s in range(s0, s0 + g):
        x = radix2_plain(fc, x, tw, 1 << s)
    return x


def tile_bits(n: int) -> int:
    """The plan's tile t for a transform of n = 2^k (``ntt_tile_bits`` of
    csrc/ntt.cuh, as the built library has it): a pass holds at most 2^t
    elements a block."""
    return cuda_lib().kzg_ntt_tile(n.bit_length() - 1)


def pass_plan(n: int, t: int) -> list[tuple[int, int]]:
    """(s0, g) of each pass of a transform of n = 2^k with tiles of 2^t
    elements: ceil(k / t) passes of min(t, stages left) stages."""
    k = n.bit_length() - 1
    return [(s0, min(t, k - s0)) for s0 in range(0, k, t)]


def ntt_pass(fc: FieldConsts, x: torch.Tensor, tw: torch.Tensor, s0: int,
             g: int, t: int, out: torch.Tensor | None = None
             ) -> torch.Tensor:
    """One launch: stages s0 .. s0 + g - 1 of the transform of x (L, n)
    against tw (L, n/2), tiles of 2^t elements (g <= t <= 11), into ``out``
    (a new tensor if None; may be x itself)."""
    if cuda_fr._on_cpu(x, tw):
        y = ntt_pass_plain(fc, x, tw, s0, g)
        return y if out is None else out.copy_(y)
    out = torch.empty_like(x) if out is None else out
    cuda_fr._require_cuda("ntt_pass", x, tw, out)
    L, n = x.shape
    if L != fc.num_limbs or n < 2 or n & (n - 1) \
            or tw.shape != (L, n // 2) or out.shape != x.shape:
        raise ValueError(f"ntt_pass: expected x and out ({fc.num_limbs}, "
                         f"2^k), k >= 1, and tw (L, n/2), got "
                         f"{tuple(x.shape)}, "
                         f"{tuple(out.shape)}, {tuple(tw.shape)}")
    if s0 < 0 or not 1 <= g <= t or 1 << (s0 + g) > n:
        raise ValueError(f"ntt_pass: bad stages {s0}..{s0 + g - 1} for "
                         f"n = {n}, tile 2^{t}")
    count_launch("ntt_pass", width=n, limbs=L)
    check(cuda_lib().kzg_ntt_pass(x.data_ptr(), out.data_ptr(),
                                  tw.data_ptr(), n, s0, g, t, fc.ptr,
                                  cuda_fr._stream(x)), "ntt_pass")
    return out


def butterfly_plain(fc: FieldConsts, xl: torch.Tensor, xu: torch.Tensor,
                    tw: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K10 plain version over (L, n); mask (n,) int32, nonzero = upper."""
    f = cuda_fr.PlainField(fc)
    prod = f.mul(xu, tw)
    return torch.where((mask != 0)[None], f.sub(xl, prod), f.add(xl, prod))


def fr_butterfly(fc: FieldConsts, xl: torch.Tensor, xu: torch.Tensor,
                 tw: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K10: mask ? xl - tw xu : xl + tw xu over (L, n), mask (n,) int32."""
    if cuda_fr._on_cpu(xl, xu, tw, mask):
        return butterfly_plain(fc, xl, xu, tw, mask)
    cuda_fr._require_cuda("fr_butterfly", xl, xu, tw, mask)
    n = xl.shape[-1]
    if xl.shape != (fc.num_limbs, n) or xu.shape != xl.shape \
            or tw.shape != xl.shape or mask.shape != (n,):
        raise ValueError(f"fr_butterfly: expected (L, n) operands and an "
                         f"(n,) mask, got {tuple(xl.shape)}, "
                         f"{tuple(xu.shape)}, {tuple(tw.shape)}, "
                         f"{tuple(mask.shape)}")
    out = torch.empty_like(xl)
    count_launch("fr_butterfly", limbs=fc.num_limbs)
    check(cuda_lib().kzg_fr_butterfly(xl.data_ptr(), xu.data_ptr(),
                                      tw.data_ptr(), mask.data_ptr(),
                                      out.data_ptr(), n, fc.ptr,
                                      cuda_fr._stream(xl)), "fr_butterfly")
    return out


def staged_transform(fc: FieldConsts, x: torch.Tensor, tw: torch.Tensor
                     ) -> torch.Tensor:
    """Bit-reversed (L, n) input -> natural-order transform (L, n): the
    plain stages on the CPU, else the passes of ``pass_plan`` with the
    library's tile for n, the first out of place, the rest in place.  An
    (L, ..., n) batch is transformed row after row along its last axis."""
    if x.dim() > 2:
        L, n = x.shape[0], x.shape[-1]
        rows = x.reshape(L, -1, n).transpose(0, 1)
        out = torch.stack([staged_transform(fc, r, tw) for r in rows], dim=1)
        return out.reshape(x.shape)
    n = x.shape[1]
    x = x.contiguous()
    if cuda_fr._on_cpu(x, tw):
        return ntt_pass_plain(fc, x, tw, 0, n.bit_length() - 1)
    t = tile_bits(n)
    out = None
    for s0, g in pass_plan(n, t):
        out = ntt_pass(fc, x if out is None else out, tw, s0, g, t, out)
    return x if out is None else out
