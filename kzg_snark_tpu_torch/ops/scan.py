"""K1 as the provers' chains use it: scans and fixed-exponent powers.

Wrappers of ``csrc/fr_scan_kernels.cu``, with their plain versions:

* ``fr_scan``: the exclusive scan of an (L, n) Montgomery array under the
  field product (identity R mod p) or sum (identity 0), forward or reverse,
  and its total: the JAX package's ``lax.scan`` chains of
  ``kzg_snark_tpu/ops/fr.py`` (``exclusive_prefix_prod``, ``batch_inv``'s
  lane chains, ``suffix_sums_exclusive``, ``sum_reduce``) as one launch
  whatever n, a total alone too: a single pass with decoupled look-back,
  whose state is a per-stream scratch (``_scan_state``) that each launch
  leaves zeroed;
* ``fr_pow``: a^e for every element and one exponent e < 2^(32 L) (the JAX
  ``pow_const`` scan and ``inv``), one launch whatever n.  The kernel's
  route depends only on e: e = p - 2 (an inversion, 0 mapping to 0) runs
  Montgomery's trick over tiles of ``tile()`` elements around one
  constant-time safegcd inversion a tile (``csrc/inv.cuh``), any other e
  square-and-multiply; both give the words of ``fr_pow_plain``.

L = ``fc.num_limbs``: 8 for both curves' Fr and BN254 Fq, 12 for
BLS12-381 Fq.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernels or raises.  The plain versions take CUDA tensors too
when called directly (the on-card comparison does so).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.build import check, count_launch, cuda_lib
from .cuda_fr import _on_cpu, _require_cuda, _stream, add_plain, mul_plain
from .limbs import FieldConsts, ints_to_words

MUL, ADD = 0, 1                 # SCAN_OP_MUL, SCAN_OP_ADD of csrc/scan.cuh


def tile() -> int:
    """SCAN_TILE of csrc/scan.cuh: the elements of one block of fr_scan and
    of fr_pow's inversion route, as the built library has it."""
    return cuda_lib().kzg_scan_tile()


# (device index, stream) -> the single-pass scan's state on that stream.
_STATES: dict[tuple[int, int], torch.Tensor] = {}


def _scan_state(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The scan state of ``stream`` for an n-element scan: zeroed once when
    made (or grown), then kept zero by every launch; scans on one stream
    run in order, so they share it."""
    words = cuda_lib().kzg_scan_state_words(n)
    key = (device.index, stream)
    state = _STATES.get(key)
    if state is None or state.numel() < words:
        state = torch.zeros(max(words, 2 * (0 if state is None
                                            else state.numel())),
                            dtype=torch.int32, device=device)
        _STATES[key] = state
    return state


def _identity(fc: FieldConsts, op: int, device) -> torch.Tensor:
    one = fc.tensors(device)["one"]
    return one if op == MUL else torch.zeros_like(one)


def fr_scan_plain(fc: FieldConsts, a: torch.Tensor, op: int,
                  reverse: bool = False):
    """(exclusive scan (L, n), total (L, 1)) of an (L, n) array by a
    Hillis-Steele ladder: log2 n full-width products or sums."""
    combine = mul_plain if op == MUL else add_plain
    n = a.shape[1]
    if reverse:
        a = a.flip(1)
    x = torch.cat([_identity(fc, op, a.device), a[:, :n - 1]], dim=1)
    shift = 1
    while shift < n:
        x = torch.cat([x[:, :shift],
                       combine(fc, x[:, :n - shift], x[:, shift:])], dim=1)
        shift *= 2
    total = combine(fc, x[:, n - 1:], a[:, n - 1:])
    return (x.flip(1) if reverse else x).contiguous(), total


def fr_pow_plain(fc: FieldConsts, a: torch.Tensor, exponent: int
                 ) -> torch.Tensor:
    """a^e by square-and-multiply from the low bit, one ``mul_plain`` a
    step; a^0 is one for every a."""
    result = None
    base = a
    while exponent:
        if exponent & 1:
            result = base if result is None else mul_plain(fc, result, base)
        exponent >>= 1
        if exponent:
            base = mul_plain(fc, base, base)
    if result is None:
        return fc.tensors(a.device)["one"].expand(a.shape).contiguous()
    return result


@functools.lru_cache(maxsize=None)
def inv_consts(modulus: int) -> ctypes.Array:
    """The inversion route's InvConsts (csrc/inv.cuh) of a modulus: R^3 mod
    p as L words, then p^-1 mod 2^30 (kept alive by the cache, one a
    field)."""
    fc = FieldConsts(modulus)
    r3 = pow(fc.R, 3, modulus)
    words = [int(w) for w in ints_to_words([r3], fc.num_limbs)[:, 0]]
    return (ctypes.c_uint32 * (fc.num_limbs + 1))(
        *words, pow(modulus, -1, 1 << 30))


def _scan_operand(fc: FieldConsts, a: torch.Tensor) -> tuple[int, int, int]:
    """(ld, inc, n) of an (L, n) operand whose columns are dense (step 1)
    or one column repeated (step 0, as ``expand`` makes)."""
    if a.device.type != "cuda":
        raise ValueError(f"fr_scan: operand must be on a CUDA device, got "
                         f"{a.device}")
    if a.dtype != torch.int32:
        raise TypeError(f"fr_scan: expected int32 limbs, got {a.dtype}")
    if a.dim() != 2 or a.shape[0] != fc.num_limbs or a.shape[1] < 1:
        raise ValueError(f"fr_scan: expected an ({fc.num_limbs}, n >= 1) "
                         f"operand, got {tuple(a.shape)}")
    n = a.shape[1]
    inc = 0 if n == 1 else a.stride(1)
    if inc not in (0, 1):
        raise ValueError("fr_scan: columns must be dense or repeated")
    return a.stride(0), inc, n


def fr_scan(fc: FieldConsts, a: torch.Tensor, op: int, reverse: bool = False,
            want_scan: bool = True):
    """(exclusive scan (L, n) or None, total (L, 1)) of ``a`` under ``op``
    (MUL or ADD), in column order or (``reverse``) from the last column.
    ``want_scan=False`` computes the total alone."""
    if _on_cpu(a):
        out, total = fr_scan_plain(fc, a, op, reverse)
        return (out if want_scan else None), total
    ld, inc, n = _scan_operand(fc, a)
    dev = a.device
    L = fc.num_limbs
    out = torch.empty((L, n), dtype=torch.int32, device=dev) \
        if want_scan else None
    total = torch.empty((L, 1), dtype=torch.int32, device=dev)
    stream = _stream(a)
    state = _scan_state(dev, stream, n)
    count_launch("fr_scan", width=n, limbs=L)
    check(cuda_lib().kzg_fr_scan(
        a.data_ptr(), ld, inc, n, op, int(reverse),
        out.data_ptr() if want_scan else None, total.data_ptr(),
        state.data_ptr(), fc.ptr, stream), "fr_scan")
    return out, total


def fr_pow(fc: FieldConsts, a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^e for every column of an (L, n) array; 0 <= e < 2^(32 L)."""
    L = fc.num_limbs
    if not 0 <= exponent < 1 << (32 * L):
        raise ValueError(f"fr_pow: the exponent must lie in [0, 2^{32 * L})")
    if _on_cpu(a):
        return fr_pow_plain(fc, a, exponent)
    _require_cuda("fr_pow", a)
    if a.dim() != 2 or a.shape[0] != L:
        raise ValueError(f"fr_pow: expected an ({L}, n) operand, got "
                         f"{tuple(a.shape)}")
    n = a.shape[1]
    words = (ctypes.c_uint32 * L)(
        *[int(w) for w in ints_to_words([exponent], L)[:, 0]])
    out = torch.empty_like(a)
    count_launch("fr_pow", width=n, limbs=L)
    check(cuda_lib().kzg_fr_pow(a.data_ptr(), n, ctypes.addressof(words),
                                exponent.bit_length(),
                                ctypes.addressof(inv_consts(fc.modulus)),
                                out.data_ptr(), fc.ptr, _stream(a)),
          "fr_pow")
    return out
