"""NTT stage kernels (K2-K5 replacements) and the staged transform.

Counterpart of ``kzg_snark_tpu/ops/ntt_stage.py``.  Two kernels in
``csrc/ntt_kernels.cu``, behind one entry point ``ntt_stage``, serve every
span:

* radix 2: one DIT stage of span s (replaces K3 and K5);
* radix 4: two DIT stages, spans s and 2s, in one pass over the array
  (replaces K2 and K4).

``staged_transform`` plans as ``StagedNtt.transform`` does: pair stages
whenever 4 * span <= n, else one radix-2 stage.  Input is bit-reversed,
output in natural order; values are exact, so any plan gives equal output.

``fr_butterfly`` (K10, replaces ``pallas_fr.py`` ``_butterfly_call``) is
the stage combine of the scan-mode transform (``ops/ntt.py``): pairs
aligned by the caller, ``mask ? xl - tw xu : xl + tw xu`` elementwise.

Each wrapper runs its plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from ..utils.build import check, count_launch, cuda_lib
from . import cuda_fr
from .limbs import NUM_LIMBS, FieldConsts


def radix2_plain(fc: FieldConsts, x: torch.Tensor, tw: torch.Tensor,
                 span: int) -> torch.Tensor:
    """One stage of span ``span`` on (8, n); tw is the (8, n/2) table."""
    f = cuda_fr.PlainField(fc)
    L, n = x.shape
    stride = n // (2 * span)
    w = tw[:, 0:span * stride:stride]                       # (8, span)
    v = x.reshape(L, n // (2 * span), 2, span)
    prod = f.mul(v[:, :, 1], w[:, None, :])
    lo = v[:, :, 0]
    return torch.stack([f.add(lo, prod), f.sub(lo, prod)], dim=2).reshape(
        L, n)


def radix4_plain(fc: FieldConsts, x: torch.Tensor, tw: torch.Tensor,
                 span: int) -> torch.Tensor:
    """Stages of spans ``span`` and ``2 * span`` on (8, n)."""
    return radix2_plain(fc, radix2_plain(fc, x, tw, span), tw, 2 * span)


def ntt_stage(fc: FieldConsts, x: torch.Tensor, tw: torch.Tensor,
              span: int, radix: int) -> torch.Tensor:
    """One pass of the stage kernels: radix 2 (one stage of span ``span``)
    or radix 4 (spans ``span`` and ``2 * span``) on (8, n), out of place."""
    if radix not in (2, 4):
        raise ValueError(f"ntt_stage: radix must be 2 or 4, got {radix}")
    if cuda_fr._on_cpu(x, tw):
        fn = radix2_plain if radix == 2 else radix4_plain
        return fn(fc, x, tw, span)
    cuda_fr._require_cuda("ntt_stage", x, tw)
    L, n = x.shape
    if L != NUM_LIMBS or tw.shape != (NUM_LIMBS, n // 2) or n & (n - 1):
        raise ValueError(f"ntt_stage: expected x (8, 2^k) and tw (8, n/2), "
                         f"got {tuple(x.shape)}, {tuple(tw.shape)}")
    if span < 1 or span & (span - 1) or radix * span > n:
        raise ValueError(f"ntt_stage: bad span {span} for radix {radix}, "
                         f"n = {n}")
    out = torch.empty_like(x)
    count_launch(f"ntt_radix{radix}")
    check(cuda_lib().kzg_ntt_stage(x.data_ptr(), out.data_ptr(),
                                   tw.data_ptr(), n, span, radix, fc.ptr,
                                   cuda_fr._stream(x)), "ntt_stage")
    return out


def butterfly_plain(fc: FieldConsts, xl: torch.Tensor, xu: torch.Tensor,
                    tw: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K10 plain version over (8, n); mask (n,) int32, nonzero = upper."""
    f = cuda_fr.PlainField(fc)
    prod = f.mul(xu, tw)
    return torch.where((mask != 0)[None], f.sub(xl, prod), f.add(xl, prod))


def fr_butterfly(fc: FieldConsts, xl: torch.Tensor, xu: torch.Tensor,
                 tw: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K10: mask ? xl - tw xu : xl + tw xu over (8, n), mask (n,) int32."""
    if cuda_fr._on_cpu(xl, xu, tw, mask):
        return butterfly_plain(fc, xl, xu, tw, mask)
    cuda_fr._require_cuda("fr_butterfly", xl, xu, tw, mask)
    n = xl.shape[-1]
    if xl.shape != (NUM_LIMBS, n) or xu.shape != xl.shape \
            or tw.shape != xl.shape or mask.shape != (n,):
        raise ValueError(f"fr_butterfly: expected (8, n) operands and an "
                         f"(n,) mask, got {tuple(xl.shape)}, "
                         f"{tuple(xu.shape)}, {tuple(tw.shape)}, "
                         f"{tuple(mask.shape)}")
    out = torch.empty_like(xl)
    count_launch("fr_butterfly")
    check(cuda_lib().kzg_fr_butterfly(xl.data_ptr(), xu.data_ptr(),
                                      tw.data_ptr(), mask.data_ptr(),
                                      out.data_ptr(), n, fc.ptr,
                                      cuda_fr._stream(xl)), "fr_butterfly")
    return out


def staged_transform(fc: FieldConsts, x: torch.Tensor, tw: torch.Tensor
                     ) -> torch.Tensor:
    """Bit-reversed (8, n) input -> natural-order transform (8, n)."""
    n = x.shape[1]
    x = x.contiguous()
    span = 1
    while span < n:
        radix = 4 if 4 * span <= n else 2
        x = ntt_stage(fc, x, tw, span, radix)
        span *= radix
    return x
