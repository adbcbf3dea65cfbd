"""Device polynomial toolkit over the scalar field.

Counterpart of ``kzg_snark_tpu/ops/polydev.py`` ``PolyDev``: NTT-based
multiplication, division by X^n - 1 in coefficient blocks, point
evaluation, the (X - z) opening division and a modular segment sum for
index-grouped accumulations (Marlin's t(X) and sparse matvecs).  All
polynomials are (8, m) Montgomery coefficient tensors as in ``ops/fr.py``.

``segment_sum_mod`` does not carry over the JAX version's 16-bit-limb
internals: each 32-bit limb is accumulated in int64 with ``index_add_``
(m values below 2^30 per segment stay below 2^63), the sums are carried
into a wide integer W < m p, and W mod p is lo + hi 2^253 mod p with
lo < 2^253 < r and hi < 2 m: one K1 product and one K1 add.  Montgomery
addition is plain modular addition, so the result is the same canonical
Montgomery integers.
"""

from __future__ import annotations

import torch

from .fr import FieldBackend, canonical_device, checked_enabled, fr_backend
from .ntt import ntt_context

SPLIT_BITS = 253            # lo = W mod 2^253 is below r (and p)


class PolyDev:
    """Per-(curve, device) polynomial operations; NTT contexts are cached
    per size.  One instance a KZG_TPU_CHECKED setting: made while the flag
    is on, it computes over the checked backend."""

    _CACHE: dict = {}

    def __new__(cls, curve_type: str, device="cuda"):
        device = canonical_device(device)
        key = (curve_type, str(device), checked_enabled())
        if key in cls._CACHE:
            return cls._CACHE[key]
        self = super().__new__(cls)
        self.curve_type = curve_type
        self.device = device
        self.be: FieldBackend = fr_backend(curve_type, device)
        from .host.field import scalar_field
        self.shift = scalar_field(curve_type).generator
        # 2^253 R mod p: the K1 product hi * c R^-1 is hi 2^253 mod p.
        be = self.be
        self._split_const = be.from_ints([pow(2, SPLIT_BITS, be.modulus)])
        cls._CACHE[key] = self
        return self

    def _ntt(self, n: int):
        return ntt_context(self.curve_type, n, self.device)

    # ------------------------------------------------------------------
    def pad(self, coeffs: torch.Tensor, m: int) -> torch.Tensor:
        L, cur = coeffs.shape
        if cur >= m:
            return coeffs[:, :m]
        return torch.cat([coeffs, torch.zeros(
            (L, m - cur), dtype=coeffs.dtype, device=coeffs.device)], dim=1)

    def mul(self, a: torch.Tensor, b: torch.Tensor, out_len: int | None = None
            ) -> torch.Tensor:
        """Polynomial product via NTT on the next power-of-two domain."""
        need = a.shape[1] + b.shape[1] - 1
        n = 1
        while n < need:
            n *= 2
        ctx = self._ntt(n)
        ea = ctx.ntt(self.pad(a, n))
        eb = ctx.ntt(self.pad(b, n))
        prod = ctx.intt(self.be.mul(ea, eb))
        return prod[:, :out_len if out_len is not None else need]

    def mul_many_evals(self, factors: list, n: int, shift: int | None = None):
        """Pointwise product of the factors' evaluations on a size-n coset
        (one iNTT away from the product polynomial)."""
        ctx = self._ntt(n)
        s = self.shift if shift is None else shift
        acc = None
        for f in factors:
            ev = ctx.coset_ntt(self.pad(f, n), s)
            acc = ev if acc is None else self.be.mul(acc, ev)
        return acc

    def from_coset_evals(self, evals: torch.Tensor, shift: int | None = None,
                         out_len: int | None = None) -> torch.Tensor:
        ctx = self._ntt(evals.shape[1])
        s = self.shift if shift is None else shift
        coeffs = ctx.coset_intt(evals, s)
        return coeffs[:, :out_len] if out_len else coeffs

    # ------------------------------------------------------------------
    def divide_by_vanishing(self, p: torch.Tensor, n: int):
        """(quotient, remainder) of p by X^n - 1, exactly: top-down in
        n-wide blocks, h_{i-n} = p_i + h_i.  p (8, m) -> h (8, max(m-n, 0))
        and r (8, n)."""
        be = self.be
        L, m = p.shape
        if m <= n:
            return p.new_zeros((L, 0)), self.pad(p, n)
        num_blocks = -(-(m - n) // n)
        p = self.pad(p, n * (num_blocks + 1))
        blocks = []
        carry = None
        for b in range(num_blocks, 0, -1):
            blk = p[:, b * n:(b + 1) * n]
            carry = blk if carry is None else be.add(blk, carry)
            blocks.append(carry)
        h = torch.cat(list(reversed(blocks)), dim=1)[:, :m - n]
        r = be.add(p[:, :n].contiguous(), self.pad(h, n))
        return h, r

    # ------------------------------------------------------------------
    def eval_at(self, coeffs: torch.Tensor, point: int) -> torch.Tensor:
        be = self.be
        return be.sum_reduce(be.mul(coeffs, be.powers_of(point,
                                                         coeffs.shape[1])))

    def eval_int(self, coeffs: torch.Tensor, point: int) -> int:
        return self.be.to_ints(self.eval_at(coeffs, point))[0]

    def open_div(self, coeffs: torch.Tensor, point: int) -> torch.Tensor:
        """(p - p(z)) / (X - z) by the suffix-scan identity
        w_j = z^-(j+1) sum_{i>j} c_i z^i."""
        be = self.be
        m = coeffs.shape[1]
        z = point % be.modulus
        u = be.mul(coeffs, be.powers_of(z, m))
        suffix = be.suffix_sums_exclusive(u)
        z_inv = pow(z, -1, be.modulus)
        inv_pows = be.mul(be.powers_of(z_inv, m), be.scalar(z_inv))
        return be.mul(suffix, inv_pows)[:, :m - 1]

    # ------------------------------------------------------------------
    def segment_sum_mod(self, values: torch.Tensor, seg_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
        """Field-element segment sum: values (8, m) Montgomery grouped by
        seg_ids (m,) int -> (8, num_segments) Montgomery."""
        be = self.be
        m = values.shape[1]
        if m >= 1 << 30:
            raise ValueError("segment_sum_mod: at most 2^30 values")
        words = values.to(torch.int64) & 0xFFFFFFFF
        L = be.num_limbs
        acc = torch.zeros((L, num_segments), dtype=torch.int64,
                          device=values.device)
        acc.index_add_(1, seg_ids.to(device=values.device, dtype=torch.int64),
                       words)
        # Carry into 32-bit words; the top word's overflow stays in carry.
        out = []
        carry = torch.zeros_like(acc[0])
        for k in range(L):
            v = acc[k] + carry
            out.append(v & 0xFFFFFFFF)
            carry = v >> 32
        top = 32 * L - SPLIT_BITS           # bits of the top word above lo
        lo_top = out[-1] & ((1 << (32 - top)) - 1)
        hi = (out[-1] >> (32 - top)) | (carry << top)
        lo = torch.stack(out[:-1] + [lo_top])
        zero = torch.zeros_like(lo[1:])
        hi_limbs = torch.cat([hi[None], zero], dim=0)
        narrow = lambda w: ((w ^ 0x80000000) - 0x80000000).to(  # noqa: E731
            torch.int32)
        hi_part = be.mul(narrow(hi_limbs), self._split_const)
        return be.add(narrow(lo), hi_part)
