"""Batched prime-field arithmetic on PyTorch tensors.

Counterpart of ``kzg_snark_tpu/ops/fr.py`` ``FieldBackend``: the same ops
with the same semantics over ``(L, ...)`` int32 limb tensors (see
``ops/limbs.py``; L = 8 for both curves' Fr and BN254 Fq, 12 for BLS12-381
Fq), Montgomery form with R = 2^(32 L), canonical values in and out.
Scalars are ``(L, 1)`` columns that broadcast over ``(L, n)``.

Elementwise mul/square/add/sub/neg go through the K1 wrappers of
``ops/cuda_fr.py``; powers, inverses, scans and reductions through
``ops/scan.py`` (``fr_pow``, ``fr_scan``), where the JAX package ran
``lax.scan`` loops: the kernels for CUDA tensors, the plain versions for
CPU tensors.  One backend serves one (modulus, device).

Checked mode (``KZG_TPU_CHECKED``, read by ``fr_backend``/``fq_backend`` at
call time): ``CheckedFieldBackend`` validates the output of every public
ring op with ``validate_canonical``, so a kernel's non-canonical output
traps at the op that produced it.  Every op here is an eager kernel call,
so the check sees every kernel output on the card (the JAX checked backend
skips traced values and never sees inside ``jit``).
"""

from __future__ import annotations

import torch

from ..config import checked_enabled
from ..utils.build import count_sync
from . import cuda_fr, scan
from .limbs import (FieldConsts, ints_to_words, to_tensor, to_words,
                    words_to_ints)


def canonical_device(device) -> torch.device:
    """torch.device with the CUDA index made explicit ("cuda" -> "cuda:0"),
    so caches keyed by device agree with ``tensor.device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class FieldBackend:
    """Montgomery-limb arithmetic for one prime modulus on one device."""

    _CACHE: dict = {}

    def __new__(cls, modulus: int, device="cuda"):
        device = canonical_device(device)
        key = (cls, modulus, str(device))
        if key in cls._CACHE:
            return cls._CACHE[key]
        self = super().__new__(cls)
        self._init(modulus, device)
        cls._CACHE[key] = self
        return self

    def _init(self, modulus: int, device: torch.device) -> None:
        self.modulus = modulus
        self.device = device
        self.consts = FieldConsts(modulus)
        fc = self.consts
        self.num_limbs = L = fc.num_limbs
        col = lambda v: to_tensor(ints_to_words([v], L), device)  # noqa: E731
        self.one_mont = col(fc.one_mont)            # (L, 1)
        self.r2_limbs = col(fc.r2)
        self.one_canonical = col(1)                 # from_mont multiplier
        self.zero_limbs = col(0)

    # ------------------------------------------------------------------
    # Host <-> device conversion (canonical ints at the boundary).
    # ------------------------------------------------------------------
    def from_ints(self, values) -> torch.Tensor:
        """Python ints -> Montgomery limb tensor (L, N) on the device."""
        p = self.modulus
        raw = to_tensor(ints_to_words([int(v) % p for v in values],
                                      self.num_limbs), self.device)
        return self.to_mont(raw)

    def to_ints(self, arr: torch.Tensor) -> list[int]:
        """Montgomery limb tensor (L, ...) -> flat list of canonical ints."""
        flat = arr.reshape(self.num_limbs, -1)
        return words_to_ints(to_words(self.from_mont(flat)))

    def scalar(self, value: int) -> torch.Tensor:
        """One element in Montgomery form, shape (L, 1)."""
        return self.from_ints([value])

    def full(self, col: torch.Tensor, count: int) -> torch.Tensor:
        """An (L, 1) column repeated to (L, count)."""
        return col.expand(self.num_limbs, count).contiguous()

    # ------------------------------------------------------------------
    # Elementwise ring ops (K1 and its add/sub entry points).
    # ------------------------------------------------------------------
    def _ewise(self, op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Apply an (L, n)-shaped wrapper to any broadcastable (L, ...)."""
        if a.dim() == 2 and b.dim() == 2 and (
                a.shape == b.shape or 1 in (a.shape[1], b.shape[1])):
            return op(self.consts, a.contiguous(), b.contiguous())
        L = self.num_limbs
        shape = torch.broadcast_shapes(a.shape, b.shape)
        if a.shape == shape and b.numel() == L:
            out = op(self.consts, a.reshape(L, -1).contiguous(),
                     b.reshape(L, 1).contiguous())
        elif b.shape == shape and a.numel() == L:
            out = op(self.consts, a.reshape(L, 1).contiguous(),
                     b.reshape(L, -1).contiguous())
        else:
            out = op(self.consts,
                     a.expand(shape).reshape(L, -1).contiguous(),
                     b.expand(shape).reshape(L, -1).contiguous())
        return out.reshape(shape)

    def mul(self, a, b):
        """Montgomery product (a b R^-1) mod p."""
        return self._ewise(cuda_fr.fr_mul, a, b)

    def square(self, a):
        return self._ewise(cuda_fr.fr_mul, a, a)

    def add(self, a, b):
        return self._ewise(cuda_fr.fr_add, a, b)

    def sub(self, a, b):
        return self._ewise(cuda_fr.fr_sub, a, b)

    def neg(self, a):
        return self._ewise(cuda_fr.fr_sub, self.zero_limbs, a)

    def double(self, a):
        return self.add(a, a)

    def to_mont(self, a_canonical):
        return self.mul(a_canonical, self.r2_limbs)

    def from_mont(self, a):
        """Montgomery -> canonical: the product with the integer 1."""
        return self.mul(a, self.one_canonical)

    # ------------------------------------------------------------------
    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(dim=0)

    def equal(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a == b).all(dim=0)

    def select(self, cond, a, b):
        """where(cond, a, b) with cond broadcast over the limb axis."""
        return torch.where(cond[None], a, b)

    # ------------------------------------------------------------------
    # Chains (K1 as they use it: fr_pow and fr_scan, a fixed number of
    # launches whatever the width or exponent).
    # ------------------------------------------------------------------
    def pow_const(self, a: torch.Tensor, exponent: int) -> torch.Tensor:
        """a^e for a static exponent; a^0 = 1 even for a = 0."""
        if exponent < 0:
            raise ValueError("negative exponents: use inv() then pow_const")
        flat = a.reshape(self.num_limbs, -1).contiguous()
        return scan.fr_pow(self.consts, flat, exponent).reshape(a.shape)

    def inv(self, a):
        """Batched inversion: a^(p-2), which fr_pow computes on its
        inversion route (Montgomery's trick around a safegcd a tile).
        inv(0) = 0."""
        return self.pow_const(a, self.modulus - 2)

    def batch_inv(self, a: torch.Tensor) -> torch.Tensor:
        """Montgomery-trick inversion of an (L, N) batch: exclusive prefix
        and suffix products, one inversion of the total (``inv``).  Zero
        entries map to zero."""
        zero = self.is_zero(a)
        safe = torch.where(zero[None], self.one_mont, a)
        pre, total = scan.fr_scan(self.consts, safe, scan.MUL)
        suf, _ = scan.fr_scan(self.consts, safe, scan.MUL, reverse=True)
        out = self.mul(self.mul(pre, suf), self.inv(total))
        return torch.where(zero[None], torch.zeros_like(out), out)

    def exclusive_prefix_prod(self, a: torch.Tensor) -> torch.Tensor:
        """out[j] = prod_{i<j} a[i] for an (L, N); out[0] = 1.  ``a`` may
        repeat one column (``expand``): the kernel reads it with step 0."""
        return scan.fr_scan(self.consts, a, scan.MUL)[0]

    def sum_reduce(self, a: torch.Tensor) -> torch.Tensor:
        """Sum an (L, N) batch along the last axis -> (L, 1)."""
        return scan.fr_scan(self.consts, a, scan.ADD, want_scan=False)[1]

    def suffix_sums_exclusive(self, a: torch.Tensor) -> torch.Tensor:
        """out[j] = sum_{i>j} a[i] for an (L, N)."""
        return scan.fr_scan(self.consts, a, scan.ADD, reverse=True)[0]

    def powers_of(self, c: int, count: int) -> torch.Tensor:
        """[1, c, ..., c^(count-1)] (L, count) Montgomery, by doubling
        concatenation (log2(count) muls)."""
        c = c % self.modulus
        table = self.one_mont
        length = 1
        while length < count:
            c_pow = self.scalar(pow(c, length, self.modulus))
            table = torch.cat([table, self.mul(table, c_pow)], dim=1)
            length *= 2
        return table[:, :count].contiguous()


class CheckedFieldBackend(FieldBackend):
    """Debug variant: every public ring op validates its output on the
    tensor's device (``validate_canonical``: int32 words, leading axis L,
    every value below p), so a missed final subtraction or a stray carry
    traps at the op that produced it rather than as a wrong proof.  One
    host sync an op: debug and CI only.  ``fr_backend``/``fq_backend``
    return this class while ``KZG_TPU_CHECKED`` is on."""

    def validate(self, x: torch.Tensor, op: str) -> torch.Tensor:
        return validate_canonical(self, x, op)


CHECKED_OPS = ("mul", "square", "add", "sub", "neg", "double", "to_mont",
               "from_mont", "pow_const", "inv", "batch_inv",
               "exclusive_prefix_prod", "sum_reduce", "suffix_sums_exclusive",
               "powers_of")


def _checked_op(name: str):
    plain = getattr(FieldBackend, name)

    def op(self, *args, **kwargs):
        return self.validate(plain(self, *args, **kwargs), name)
    op.__name__ = name
    op.__doc__ = plain.__doc__
    return op


for _name in CHECKED_OPS:
    setattr(CheckedFieldBackend, _name, _checked_op(_name))


def validate_canonical(backend: FieldBackend, x: torch.Tensor,
                       op: str = "kernel") -> torch.Tensor:
    """Check a tensor of field elements in the port's word layout: int32
    holding uint32 bits, leading axis L = ``backend.num_limbs``, and every
    value below p (words compared as unsigned, most significant first).
    Runs on the tensor's own device: a few torch ops and one host sync.
    Raises AssertionError naming ``op``; returns ``x``."""
    L = backend.num_limbs
    if not torch.is_tensor(x) or x.dtype != torch.int32:
        raise AssertionError(f"{op}: expected an int32 word tensor, got "
                             f"{getattr(x, 'dtype', type(x).__name__)}")
    if x.dim() == 0 or x.shape[0] != L:
        raise AssertionError(f"{op}: leading axis "
                             f"{x.shape[0] if x.dim() else None} != L={L}")
    flat = x.reshape(L, -1).to(torch.int64) & 0xFFFFFFFF
    p = backend.consts.tensors(x.device)["p32"]              # (L, 1)
    rows = torch.arange(L, device=x.device)[:, None]
    # The most significant word that differs from p's decides x < p.
    top = torch.where(flat != p, rows, -1).amax(dim=0)
    below = (flat < p).gather(0, top.clamp(min=0)[None])[0] & (top >= 0)
    count_sync("fr.checked")
    if not bool(below.all()):
        bad = int((~below).nonzero()[0, 0])
        value = words_to_ints(to_words(x.reshape(L, -1)[:, bad:bad + 1]))[0]
        raise AssertionError(f"{op}: non-canonical output {value} >= p at "
                             f"column {bad}")
    return x


def validate_tree_canonical(backend: FieldBackend, tree, op: str):
    """``validate_canonical`` over every leaf of nested lists, tuples and
    dicts of tensors; returns ``tree``."""
    if isinstance(tree, dict):
        leaves = tree.values()
    elif isinstance(tree, (list, tuple)):
        leaves = tree
    else:
        return validate_canonical(backend, tree, op)
    for leaf in leaves:
        validate_tree_canonical(backend, leaf, op)
    return tree


def _moduli(curve_type: str) -> tuple[int, int]:
    """(r, p): the curve's scalar and base field moduli."""
    from .. import constants as C
    if curve_type == "bn254":
        return C.BN254_R, C.BN254_P
    if curve_type == "bls12_381":
        return C.BLS12_381_R, C.BLS12_381_P
    raise ValueError(f"unsupported curve type: {curve_type}")


def _backend_class() -> type:
    return CheckedFieldBackend if checked_enabled() else FieldBackend


def fr_backend(curve_type: str = "bn254", device="cuda") -> FieldBackend:
    """The scalar field: 8 words on both curves; checked while
    KZG_TPU_CHECKED is on."""
    return _backend_class()(_moduli(curve_type)[0], device)


def fq_backend(curve_type: str = "bn254", device="cuda") -> FieldBackend:
    """The base field: 8 words at BN254, 12 at BLS12-381; checked while
    KZG_TPU_CHECKED is on."""
    return _backend_class()(_moduli(curve_type)[1], device)
