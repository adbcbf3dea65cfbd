"""Radix-2 NTT / iNTT over Fr on PyTorch tensors.

Counterpart of ``kzg_snark_tpu/ops/ntt.py`` ``NttContext``: natural-order
input and output over (8, n) Montgomery limb tensors, the deterministic
domain root of ``ops/host/field`` ``nth_root_of_unity``.  One plan serves
every size (``ops/ntt_stage.staged_transform`` on the K2-K5 kernels); the
bit reversal is a torch index gather, the n^-1 scale and coset shifts are
K1 products.
"""

from __future__ import annotations

import functools

import torch

from .fr import FieldBackend, canonical_device, fr_backend
from .ntt_stage import staged_transform


def bit_reverse_indices(n: int) -> torch.Tensor:
    bits = n.bit_length() - 1
    idx = torch.arange(n, dtype=torch.int64)
    rev = torch.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


class NttContext:
    """Twiddle tables and bit-reversal gather for one (modulus, n, root)
    on one device."""

    _CACHE: dict = {}

    def __new__(cls, backend: FieldBackend, n: int, root: int):
        key = (backend.modulus, str(backend.device), n, root)
        if key in cls._CACHE:
            return cls._CACHE[key]
        self = super().__new__(cls)
        self._init(backend, n, root)
        cls._CACHE[key] = self
        return self

    def _init(self, backend: FieldBackend, n: int, root: int) -> None:
        if n & (n - 1):
            raise ValueError("NTT size must be a power of 2")
        p = backend.modulus
        if pow(root, n, p) != 1 or (n > 1 and pow(root, n // 2, p) == 1):
            raise ValueError("root must have order exactly n")
        self.backend = backend
        self.n = n
        self.root = root
        self.bitrev = bit_reverse_indices(n).to(backend.device)
        half = max(n // 2, 1)
        self.tw_fwd = backend.powers_of(root, half)
        self.tw_inv = backend.powers_of(pow(root, -1, p) if n > 1 else 1,
                                        half)
        self.n_inv = backend.scalar(pow(n, -1, p))

    def _transform(self, values: torch.Tensor, table: torch.Tensor
                   ) -> torch.Tensor:
        if self.n == 1:
            return values
        return staged_transform(self.backend.consts,
                                values[:, self.bitrev], table)

    def ntt(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Evaluate: out[:, i] = p(w^i).  coeffs (8, n) Montgomery form."""
        return self._transform(coeffs, self.tw_fwd)

    def intt(self, evals: torch.Tensor) -> torch.Tensor:
        """Interpolate: inverse transform scaled by n^-1."""
        return self.backend.mul(self._transform(evals, self.tw_inv),
                                self.n_inv)

    def powers(self, c: int) -> torch.Tensor:
        """[1, c, ..., c^(n-1)] (8, n) Montgomery."""
        return self.backend.powers_of(c, self.n)

    def coset_ntt(self, coeffs: torch.Tensor, shift: int) -> torch.Tensor:
        """Evaluate on the coset shift * H: NTT of coeffs[i] * shift^i."""
        return self.ntt(self.backend.mul(coeffs, self._shift_powers(shift)))

    def coset_intt(self, evals: torch.Tensor, shift: int) -> torch.Tensor:
        inv_shift = pow(shift, -1, self.backend.modulus)
        return self.backend.mul(self.intt(evals),
                                self._shift_powers(inv_shift))

    def _shift_powers(self, c: int) -> torch.Tensor:
        cache = self.__dict__.setdefault("_shift_cache", {})
        if c not in cache:
            cache[c] = self.powers(c)
        return cache[c]


@functools.lru_cache(maxsize=None)
def _root(curve_type: str, n: int) -> int:
    from kzg_snark_tpu.ops.host.field import scalar_field
    return int(scalar_field(curve_type).nth_root_of_unity(n)) if n > 1 else 1


def ntt_context(curve_type: str, n: int, device="cpu") -> NttContext:
    """Context over the curve's scalar field with the framework's
    deterministic domain generator."""
    be = fr_backend(curve_type, canonical_device(device))
    return NttContext(be, n, _root(curve_type, n))
