"""Radix-2 NTT / iNTT over Fr on PyTorch tensors.

Counterpart of ``kzg_snark_tpu/ops/ntt.py`` ``NttContext``: natural-order
input and output over (8, ..., n) Montgomery limb tensors, transformed
along the last axis (the middle axes are a batch, as in the JAX
``_transform``), the deterministic domain root of ``ops/host/field``
``nth_root_of_unity``.  Two modes, chosen by the caller or, with
``mode=None``, by ``KZG_TPU_NTT_MODE`` read at call time (``resolve_mode``,
the same for both: "auto" and "staged" mean staged, "scan" means scan; the
JAX package's XLA-only "gather" and "unrolled", or any other value, raise):

* ``"staged"``: ``ops/ntt_stage.staged_transform``, the
  K2-K5 replacement ``ntt_pass`` (as many stages a launch as a
  shared-memory tile holds, the passes of a batch row after row), the
  bit reversal a torch index gather;
* ``"scan"``: the JAX ``_transform_scan`` (``KZG_TPU_NTT_MODE=scan``): the
  bit reversal by two half-width gathers and a transpose, then per stage
  two rolls align the pairs and the K10 kernel combines them against a
  full-width twiddle row (the (stages, 8, n) rows are built on first use;
  a batch is one launch a stage, its rows side by side).

The n^-1 scale and coset shifts are K1 products.  Values are exact, so
both modes give equal output.  Under a profiler each public transform is
a span, ``ntt.<method>`` (``ntt.intt``, ``ntt.coset_ntt``, ...; a coset
transform holds the plain one's span).
"""

from __future__ import annotations

import functools

import torch

from ..config import NTT_MODE_VAR, env_ntt_mode
from ..utils.profiling import span
from .fr import FieldBackend, canonical_device, fr_backend
from .ntt_stage import fr_butterfly, staged_transform

MODES = {"auto": "staged", "staged": "staged", "scan": "scan"}


def resolve_mode(mode: str | None) -> str:
    """The transform that ``mode`` runs; None reads KZG_TPU_NTT_MODE now."""
    given = env_ntt_mode() if mode is None else mode
    if given not in MODES:
        where = f"{NTT_MODE_VAR}=" if mode is None else "mode "
        raise ValueError(f"{where}{given!r}: the port's NTT modes are "
                         f"{sorted(MODES)}")
    return MODES[given]


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
        key = (type(backend), backend.modulus, str(backend.device), n, root)
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

    def _transform(self, values: torch.Tensor, forward: bool,
                   mode: str | None) -> torch.Tensor:
        mode = resolve_mode(mode)
        if self.n == 1:
            return values
        if mode == "scan":
            return self._transform_scan(values, forward)
        table = self.tw_fwd if forward else self.tw_inv
        return staged_transform(self.backend.consts,
                                values[..., self.bitrev], table)

    def ntt(self, coeffs: torch.Tensor, mode: str | None = None
            ) -> torch.Tensor:
        """Evaluate: out[..., i] = p(w^i).  coeffs (8, ..., n) Montgomery
        form; ``mode`` as ``resolve_mode``."""
        with span("ntt.ntt"):
            return self._transform(coeffs, True, mode)

    def intt(self, evals: torch.Tensor, mode: str | None = None
             ) -> torch.Tensor:
        """Interpolate: inverse transform scaled by n^-1."""
        with span("ntt.intt"):
            out = self._transform(evals, False, mode)
            return self.backend.mul(out, _over(self.n_inv, out))

    # -- scan mode (K10) -------------------------------------------------
    def _bitrev_2d(self, values: torch.Tensor) -> torch.Tensor:
        """Bit reversal by two half-width gathers and a transpose: for
        i = a 2^h2 + b, rev(i) = rev_h1(a) 2^h2 + rev_h2(b)."""
        bits = self.n.bit_length() - 1
        h1 = bits // 2
        h2 = bits - h1
        A, B = 1 << h1, 1 << h2
        dev = values.device
        rev_a = bit_reverse_indices(A).to(dev)
        rev_b = bit_reverse_indices(B).to(dev)
        lead = values.shape[:-1]
        x2d = values.reshape(lead + (A, B))[..., rev_a, :][..., rev_b]
        return x2d.transpose(-1, -2).reshape(lead + (self.n,))

    def _stage_twiddles(self, forward: bool) -> torch.Tensor:
        """(stages, 8, n) rows: row t, column i holds
        w^((i mod 2^t) n / 2^(t+1)).  Built on the first scan-mode call."""
        attr = "_stage_tw_fwd" if forward else "_stage_tw_inv"
        if attr not in self.__dict__:
            table = self.tw_fwd if forward else self.tw_inv
            n = self.n
            rows = []
            for t in range(n.bit_length() - 1):
                span = 1 << t
                stride = n // (2 * span)
                rows.append(table[:, 0:span * stride:stride].repeat(
                    1, n // span))
            setattr(self, attr, torch.stack(rows))
        return self.__dict__[attr]

    def _transform_scan(self, values: torch.Tensor, forward: bool
                        ) -> torch.Tensor:
        fc = self.backend.consts
        tws = self._stage_twiddles(forward)
        x = self._bitrev_2d(values)
        L, rows = x.shape[0], x[0].numel() // self.n
        idx = torch.arange(self.n, dtype=torch.int32, device=x.device)
        for t in range(tws.shape[0]):
            span = 1 << t
            upper = (idx & span) != 0
            xl = torch.where(upper, torch.roll(x, span, dims=-1), x)
            xu = torch.where(upper, x, torch.roll(x, -span, dims=-1))
            tw, mask = tws[t], upper.to(torch.int32)
            if rows > 1:    # the batch's rows side by side: one launch
                tw, mask = tw.repeat(1, rows), mask.repeat(rows)
            x = fr_butterfly(fc, xl.reshape(L, -1).contiguous(),
                             xu.reshape(L, -1).contiguous(), tw,
                             mask).reshape(x.shape)
        return x

    def powers(self, c: int) -> torch.Tensor:
        """[1, c, ..., c^(n-1)] (8, n) Montgomery."""
        return self.backend.powers_of(c, self.n)

    def coset_ntt(self, coeffs: torch.Tensor, shift: int) -> torch.Tensor:
        """Evaluate on the coset shift * H: NTT of coeffs[i] * shift^i."""
        with span("ntt.coset_ntt"):
            return self.ntt(self.backend.mul(
                coeffs, _over(self._shift_powers(shift), coeffs)))

    def coset_intt(self, evals: torch.Tensor, shift: int) -> torch.Tensor:
        with span("ntt.coset_intt"):
            inv_shift = pow(shift, -1, self.backend.modulus)
            out = self.intt(evals)
            return self.backend.mul(
                out, _over(self._shift_powers(inv_shift), out))

    def _shift_powers(self, c: int) -> torch.Tensor:
        cache = self.__dict__.setdefault("_shift_cache", {})
        if c not in cache:
            cache[c] = self.powers(c)
        return cache[c]


def _over(row: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """An (L, k) row shaped (L, 1, ..., 1, k) to broadcast over the batch
    axes of x (L, ..., n)."""
    return row.reshape((row.shape[0],) + (1,) * (x.dim() - 2)
                       + (row.shape[-1],))


@functools.lru_cache(maxsize=None)
def _root(curve_type: str, n: int) -> int:
    from .host.field import scalar_field
    return int(scalar_field(curve_type).nth_root_of_unity(n)) if n > 1 else 1


def ntt_context(curve_type: str, n: int, device="cuda") -> NttContext:
    """Context over the curve's scalar field with the framework's
    deterministic domain generator."""
    be = fr_backend(curve_type, canonical_device(device))
    return NttContext(be, n, _root(curve_type, n))
