"""Distributed NTT: the four-step (Bailey) decomposition over the ranks of a
mesh axis.

Counterpart of ``kzg_snark_tpu/parallel/ntt_dist.py``, with its layouts
word for word, each rank holding its own slice of the JAX global array:

* input, "cyclic": rank d holds c[d::D] as its local (8, 1, n2), n2 = n/D;
* output, "blocked-transposed": rank d holds (8, 1, n2/D, D) with
  [:, 0, j, k1] = X[n2 k1 + d n2/D + j], X the natural-order NTT.

A length-n transform over D ranks (``ntt``; ``intt`` runs it backwards):

1. the column transform of length n2, root w^D: the port's ``NttContext``
   (``ntt_pass``, K2-K5, in the mode ``KZG_TPU_NTT_MODE`` names);
2. the twiddle product by row d of w^(i1 k2) (K1); each rank builds only
   its own row, the powers of w^d, equal to the JAX table's row d;
3. one ``all_to_all`` of the (D, 8, n2/D) blocks (the JAX all_to_all
   splits axis 1; here the blocks lead, contiguous);
4. the row transforms of length D, root w^(n2), along the last axis in
   scan mode: one ``fr_butterfly`` (K10) launch a stage for the n2/D rows
   together, log2(D) launches, never one launch a row.

The inverse undoes them in reverse order, with the D^-1 scale of the row
iNTT and the n2^-1 of the column iNTT.  Where n < D^2 the blocks would be
fractional and the ``small`` fallback gathers the vector, transforms it
whole and keeps the rank's cyclic slice (cyclic to cyclic), as the JAX one
does.  Under ``KZG_TPU_CHECKED`` the outputs are validated
(``validate_canonical``) on the card.
"""

from __future__ import annotations

import torch

from ..config import checked_enabled
from ..ops.fr import CheckedFieldBackend, canonical_device, fr_backend, \
    validate_canonical
from ..ops.ntt import NttContext, _root
from ..utils.build import COLLECTIVES
from .mesh import AXIS, all_gather, all_to_all, axis_group


class DistNttContext:
    """Plan of a length-n NTT over the D ranks of ``axis`` (a mesh axis or
    a tuple of axes, flat index major-first); n and D powers of 2, D | n.
    Every rank of the axis builds it and calls its methods together."""

    _CACHE: dict = {}

    def __new__(cls, curve_type: str, n: int, mesh, axis=None,
                device="cuda"):
        device = canonical_device(device)
        key = (curve_type, n, id(mesh), axis, str(device), checked_enabled())
        if key in cls._CACHE:
            return cls._CACHE[key]
        self = super().__new__(cls)
        self._init(curve_type, n, mesh, AXIS if axis is None else axis,
                   device)
        cls._CACHE[key] = self
        return self

    def _init(self, curve_type: str, n: int, mesh, axis, device) -> None:
        self.mesh, self.axis = mesh, axis
        self.group, D, self.index = axis_group(mesh, axis)
        if n % D or n & (n - 1):
            raise ValueError(f"n = {n} must be a power of 2 divisible by "
                             f"the {D} ranks")
        n2 = n // D
        self.n, self.D, self.n2 = n, D, n2
        self.small = n2 % D != 0          # n < D^2
        self.backend = be = fr_backend(curve_type, device)
        p = be.modulus
        self.root = w = _root(curve_type, n)
        self.issued: dict | None = None   # collectives of the last ntt()
        if self.small:
            self.ctx_full = NttContext(be, n, w)
            return
        self.ctx_cols = NttContext(be, n2, pow(w, D, p))       # step 1
        self.ctx_rows = NttContext(be, D, pow(w, n2, p))       # step 4
        self.tw = be.powers_of(pow(w, self.index, p), n2)      # step 2
        self.tw_inv = be.powers_of(pow(w, -self.index, p), n2)

    # ------------------------------------------------------------------
    def _expect(self, x: torch.Tensor, shape: tuple, what: str) -> None:
        if tuple(x.shape) != shape:
            raise ValueError(f"{what}: expected the rank's local slice "
                             f"{shape}, got {tuple(x.shape)}")

    def _checked(self, out: torch.Tensor, op: str) -> torch.Tensor:
        if isinstance(self.backend, CheckedFieldBackend):
            validate_canonical(self.backend, out, f"dist_ntt.{op}")
        return out

    def _small(self, x: torch.Tensor, forward: bool) -> torch.Tensor:
        """n < D^2: gather the cyclic slices, transform the whole vector,
        keep this rank's cyclic slice."""
        L, D = self.backend.num_limbs, self.D
        full = all_gather(x[:, 0], D, self.group)             # (D, L, n2)
        nat = full.permute(1, 2, 0).reshape(L, self.n)
        ctx = self.ctx_full
        out = ctx.ntt(nat) if forward else ctx.intt(nat)
        return out.reshape(L, self.n2, D)[:, None, :, self.index] \
            .contiguous()

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """Local cyclic (8, 1, n2) -> local blocked-transposed
        (8, 1, n2/D, D); cyclic -> cyclic where ``small``."""
        be, D, n2 = self.backend, self.D, self.n2
        L = be.num_limbs
        self._expect(x, (L, 1, n2), "ntt")
        before = COLLECTIVES.copy()
        if self.small:
            out = self._small(x, True)
        else:
            v = self.ctx_cols.ntt(x[:, 0])                     # step 1
            v = be.mul(v, self.tw)                             # step 2
            recv = all_to_all(v.reshape(L, D, n2 // D).transpose(0, 1),
                              self.group)                      # step 3
            # recv[e, :, j] = rank e's column j of my block -> (L, n2/D, D)
            rows = recv.permute(1, 2, 0).contiguous()
            out = self.ctx_rows.ntt(rows, mode="scan")[:, None]  # step 4
        self.issued = dict(COLLECTIVES - before)
        return self._checked(out, "ntt")

    def intt(self, y: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`ntt`: back to the local cyclic (8, 1, n2)."""
        be, D, n2 = self.backend, self.D, self.n2
        L = be.num_limbs
        if self.small:
            self._expect(y, (L, 1, n2), "intt")
            return self._checked(self._small(y, False), "intt")
        self._expect(y, (L, 1, n2 // D, D), "intt")
        v = self.ctx_rows.intt(y[:, 0].contiguous(), mode="scan")
        recv = all_to_all(v.permute(2, 0, 1), self.group)     # (D, L, n2/D)
        v = recv.transpose(0, 1).reshape(L, n2)
        v = be.mul(v, self.tw_inv)
        return self._checked(self.ctx_cols.intt(v)[:, None], "intt")

    # ------------------------------------------------------------------
    def collective_stats(self) -> dict:
        """The JAX ``collective_stats`` keys but its HLO count: the
        collectives this rank's last ``ntt`` issued ("collectives_issued",
        None before the first), and the analytic bytes for the port's 8
        words an element: the four-step moves (D - 1) / D of the local
        slice across ranks in its one all_to_all."""
        local_bytes = self.backend.num_limbs * self.n2 * 4
        cross = 0 if self.small else local_bytes * (self.D - 1) // self.D
        return {
            "n": self.n, "devices": self.D,
            "collectives_issued": self.issued,
            "bytes_local_slice_per_device": local_bytes,
            "bytes_cross_mesh_per_device_per_transform": cross,
            "single_device_cross_bytes": 0,
        }

    # ------------------------------------------------------------------
    # Layout converters (every rank of the axis calls them together).
    # ------------------------------------------------------------------
    def natural_to_cyclic(self, coeffs: torch.Tensor) -> torch.Tensor:
        """The whole (8, n) natural-order vector -> this rank's cyclic
        slice (8, 1, n2)."""
        return coeffs[:, self.index::self.D][:, None].contiguous()

    def blocked_to_natural(self, y: torch.Tensor) -> torch.Tensor:
        """Gather the blocked-transposed slices -> (8, n) natural order on
        every rank; ``small`` outputs are cyclic."""
        if self.small:
            return self.cyclic_to_natural(y)
        L, D = self.backend.num_limbs, self.D
        full = all_gather(y[:, 0], D, self.group)      # [d, :, j, k1]
        return full.permute(1, 3, 0, 2).reshape(L, self.n)

    def cyclic_to_natural(self, x: torch.Tensor) -> torch.Tensor:
        """Gather the cyclic slices -> (8, n) natural order on every
        rank."""
        full = all_gather(x[:, 0], self.D, self.group)        # (D, L, n2)
        return full.permute(1, 2, 0).reshape(self.backend.num_limbs, self.n)
