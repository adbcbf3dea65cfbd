"""PeerDAS cells and their KZG proofs on the card: EIP-7594's
``compute_cells_and_kzg_proofs`` by FK20 (Feist and Khovratovich, "Fast
amortized KZG proofs", eprint 2023/033), for k polynomials at once.

A polynomial f of degree < n is extended to its 2n values on the domain of
the primitive 2n-th root w (``eval_dev``), read in bit-reversed order and
cut into N = 2n / l cells of l values: cell i lies on the coset
h_i <w^N>, h_i = w^rev(i) (rev over log2 N bits), the consensus specs'
``coset_for_cell``.  Its proof is [q_i(tau)], q_i = (f - I_i) / (X^l - a_i),
a_i = h_i^l.  With m = n / l and f = sum_k X^(k l) F_k (deg F_k < l):

    q_i = sum_{t=1}^{m-1} a_i^(t-1) H_t,  H_t = sum_{k>=t} X^((k-t) l) F_k,

so every proof is a combination of the m - 1 points C_t = [H_t(tau)], and
C_t = sum_{j<l} sum_u f_((t+u) l + j) [tau^(u l + j)] is, for each offset j,
a Toeplitz product of coefficient column j against SRS column j.  In a
circulant of size N = 2m, with u the root of order N:

* set-up (``circulant_table``, once an SRS): S^_j = DFT_N(SRS column j,
  reversed), N x l points, by one grouped MSM on the card;
* ``proofs_dev``, per batch: f^_j = DFT_N(coefficient column j), one
  batched NTT (``fk20.columns``); C^_v = sum_j f^_j[v] S^_j[v] for v < N,
  one grouped MSM of N groups of l points and k sets (``fk20.msm``); then
  pi_i = sum_v P[i, v] C^_v, P = (the DFT read at a_i) o (truncation to
  t = 1 .. m - 1) o iDFT_N, a fixed N x N matrix whose rows hold m - 1
  equal entries: with the two sums E_p of the C^_v of each parity (a
  halving tree of complete adds) as two more points, a second grouped MSM
  of k groups (the blobs) of N + 2 points and N sets, m + 2 nonzero
  scalars a set (``fk20.g1_dft``, ``proof_matrix``).

No step loops over blobs or cells in Python and none waits for the host:
a batch of any k makes the same launches.  The C^_v are computed on the
card, so the second MSM uses complete adds, and a C^_v or E_p that is the
identity (as in a zero blob) has its scalars zeroed, so the MSM never
reads its point.
"""

from __future__ import annotations

import torch

from ..utils.build import count_sync
from ..utils.profiling import span
from . import cuda_fr, ntt_stage
from .benchpoints import normalize_points
from .limbs import ints_to_words, to_tensor, to_words
from .msm import msm_context
from .msm_grouped import grouped_table, window_bits
from .ntt import bit_reverse_indices, ntt_context

FIELD_ELEMENTS_PER_CELL = 64       # EIP-7594


def _words(values: list, device) -> torch.Tensor:
    return to_tensor(ints_to_words(values), device)


def ntt_rows(be, curve_type: str, x: torch.Tensor) -> torch.Tensor:
    """The NTT of every row of x (8, R, N) Montgomery coefficients ->
    (8, R, N) values at the N-th roots, in the passes of one row's
    transform, whatever R (``NttContext.ntt`` runs a batch row after
    row).  The rows, each bit-reversed, are laid end to end and padded
    with zero rows to T = 2^j >= R N; a pass over the first stages of a
    transform of T combines elements only inside aligned runs of N, with
    the twiddles w_T^(j T / 2^(s+1)) = w_N^(j N / 2^(s+1)) of the table of
    T (every root is g^((r - 1) / size), g the field's generator)."""
    with span("ntt.ntt"):
        L, R, N = x.shape
        T = (1 << (R - 1).bit_length()) * N
        ctx = ntt_context(curve_type, T, x.device)
        flat = torch.zeros((L, T), dtype=x.dtype, device=x.device)
        rev = ntt_context(curve_type, N, x.device).bitrev
        flat[:, :R * N] = x[..., rev].reshape(L, R * N)
        # The plain passes (CPU tensors) take any tile: one pass.
        t = N.bit_length() - 1 if cuda_fr._on_cpu(flat) \
            else ntt_stage.tile_bits(T)
        for s0, g in ntt_stage.pass_plan(N, t):
            flat = ntt_stage.ntt_pass(be.consts, flat, ctx.tw_fwd, s0, g, t,
                                      flat)
        return flat[:, :R * N].reshape(L, R, N)


def circulant_inputs(srs, n: int, l: int):
    """The set-up table's grouped MSM: bases (3, L, l m), group j the SRS
    column j, [tau^(u l + j)] for u < m, and scalars (l, N, 8, m), set v of
    every group u^(-u v) for u < m."""
    r = msm_context(srs.curve_type, srs.device).scalar_backend.modulus
    m, N = n // l, 2 * (n // l)
    w_inv = pow(ntt_context(srs.curve_type, N, srs.device).root, -1, r)
    powers = [pow(w_inv, e, r) for e in range(N)]
    dev = srs.device
    col = (torch.arange(l)[:, None] + l * torch.arange(m)[None, :])
    bases = srs.points[..., col.reshape(-1).to(dev)]        # group j: column j
    sc = _words([powers[u * v % N] for v in range(N) for u in range(m)], dev)
    sc = sc.reshape(8, N, m).permute(1, 0, 2)               # (N, 8, m)
    return bases, sc[None].expand(l, N, 8, m).contiguous()


def circulant_table(srs, n: int, l: int) -> torch.Tensor:
    """The FK20 set-up table of the first n SRS points for cells of l:
    S^_j[v] = sum_{u<m} u^(-u v) [tau^(u l + j)] for v < N = 2m, j < l,
    by one grouped MSM (``circulant_inputs``), as affine points in the
    (N l, 2 L) table of the Toeplitz products' grouped MSM (group v holds
    S^_j[v] at v l + j)."""
    ctx = msm_context(srs.curve_type, srs.device)
    N = 2 * (n // l)
    S = ctx.msm_grouped(*circulant_inputs(srs, n, l),
                        complete=True)                       # (3, L, l, N)
    L = ctx.curve.num_limbs
    S = S.permute(0, 1, 3, 2).reshape(3, L, N * l).contiguous()
    count_sync("fk20.setup")
    if bool(ctx.curve.is_identity(S).any()):
        raise ValueError("FK20 set-up: a table point is the identity")
    return grouped_table(normalize_points(ctx.curve.f, S))


def proof_matrix(curve_type: str, n: int, l: int) -> list:
    """Rows of N + 2 scalars, one a cell i < N: pi_i = sum_v P[i][v] C^_v
    + P[i][N + p] E_p, E_p = sum_{v = p mod 2} C^_v.

    The transform's own matrix is (1/N) sum_{t=1}^{m-1} a_i^(t-1) u^(-t v),
    a geometric sum in x = a_i u^(-v) = u^(rev(i) - v) (a_i = w^(l rev(i))
    = u^rev(i)).  Where v has rev(i)'s parity x^m = 1, and the entry is
    c_i = -(1/N) u^(-rev(i)) for each such v but rev(i), where it is
    -(m - 1) c_i: half a row's scalars are equal, which puts half a set's
    digits in one bucket a window.  So those columns take c_i once, through
    E_p, and keep only -m c_i at v = rev(i); the other parity's entries,
    -c_i (1 + x) / (1 - x), are distinct.  A row has m + 2 nonzero
    scalars."""
    from .host.field import scalar_field
    r = scalar_field(curve_type).modulus
    m, N = n // l, 2 * (n // l)
    w = ntt_context(curve_type, 2 * n, "cpu").root
    u = ntt_context(curve_type, N, "cpu").root
    if pow(w, l, r) != u:
        raise ValueError("FK20: the roots of 2n and N disagree")
    u_inv, n_inv = pow(u, -1, r), pow(N, -1, r)
    rev = bit_reverse_indices(N).tolist()
    rows = []
    for i in range(N):
        ri = rev[i]
        c = -n_inv * pow(u_inv, ri, r) % r
        row = [0] * (N + 2)
        row[ri] = -m * c % r
        for v in range(1 - ri % 2, N, 2):
            x = pow(u, (ri - v) % N, r)
            row[v] = -c * (1 + x) * pow(1 - x, -1, r) % r
        row[N + ri % 2] = c
        rows.append(row)
    return rows


class CellsDeviceCore:
    """FK20 for polynomials of degree < n and cells of l values over one
    device SRS: the set-up table and the proof matrix, made once
    (``cells_core``)."""

    def __init__(self, srs, n: int, l: int):
        if n & (n - 1) or l & (l - 1) or not 1 <= l <= n // 2 \
                or len(srs) < n:
            raise ValueError(f"FK20: n = {n}, cells of {l}, an SRS of "
                             f"{len(srs)}: n and l powers of two, l <= n / 2,"
                             f" n SRS points")
        self.n, self.l, self.m = n, l, n // l
        self.cells = N = 2 * self.m
        dev = srs.device
        self.curve_type = srs.curve_type
        self.ctx = msm_context(srs.curve_type, dev)
        self.be = self.ctx.scalar_backend
        self.order = bit_reverse_indices(2 * n).to(dev)
        self.table = circulant_table(srs, n, l)
        P = proof_matrix(srs.curve_type, n, l)
        self.proof_scalars = _words([x for row in P for x in row], dev) \
            .reshape(8, N, N + 2).permute(1, 0, 2).contiguous()  # (N,8,N+2)

    def eval_dev(self, coeffs: torch.Tensor, order: torch.Tensor
                 ) -> torch.Tensor:
        """Values of coefficient rows (8, k, n) Montgomery at w^e for e in
        ``order``, indices into the extended domain of 2n points ->
        (8, k len(order)) Montgomery, row after row (the field backend's
        (L, n) layout)."""
        full = torch.cat([coeffs, torch.zeros_like(coeffs)], dim=-1)
        return ntt_rows(self.be, self.curve_type, full)[..., order] \
            .reshape(8, -1)

    def cells_dev(self, values: torch.Tensor) -> torch.Tensor:
        """``eval_dev``'s values in the cells' order -> (8, k, N, l)
        canonical words."""
        canon = self.be.from_mont(values.reshape(8, -1))
        return canon.reshape(8, -1, self.cells, self.l)

    def column_scalars(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Coefficient rows (8, k, n) Montgomery -> the Toeplitz products'
        scalars (N, k, 8, l) canonical: f^_j[v], set b of group v."""
        be, l, m, N = self.be, self.l, self.m, self.cells
        k = coeffs.shape[1]
        with span("fk20.columns"):
            cols = coeffs.reshape(8, k, m, l).transpose(2, 3)   # (8, k, l, m)
            cols = torch.cat([cols, torch.zeros_like(cols)], dim=-1)
            fhat = ntt_rows(be, self.curve_type, cols.reshape(8, k * l, N))
            canon = be.from_mont(fhat.reshape(8, -1)).reshape(8, k, l, N)
            return canon.permute(3, 1, 0, 2).contiguous()

    def transform_inputs(self, chat: torch.Tensor):
        """The C^_v (3, L, N, k) -> the G1 transform's grouped MSM: its
        table (k (N + 2), 2 L), group b the blob's N points C^_v and its two
        parity sums E_p, and scalars (k, N, 8, N + 2), the proof matrix's
        rows with a point's column zeroed where it is the identity.  Its
        window is ``transform_c``."""
        ctx, N = self.ctx, self.cells
        L, k = ctx.curve.num_limbs, chat.shape[-1]
        E = chat.reshape(3, L, N // 2, 2, k)                   # v = 2 j + p
        while E.shape[2] > 1:
            h = E.shape[2] // 2
            E = ctx.curve.add(E[:, :, :h], E[:, :, h:])
        bases = torch.cat([chat, E[:, :, 0]], dim=2)           # (3,L,N+2,k)
        X, Y, Z = bases.permute(0, 1, 3, 2).reshape(3, L, k * (N + 2))
        f = ctx.curve.f
        zinv = f.inv(Z)
        zinv2 = f.mul(zinv, zinv)
        xy = torch.stack([f.mul(X, zinv2), f.mul(Y, f.mul(zinv2, zinv))])
        ident = f.is_zero(Z).reshape(k, 1, 1, N + 2)
        return grouped_table(xy), torch.where(ident, 0,
                                              self.proof_scalars[None])

    @property
    def transform_c(self) -> int:
        """The G1 transform's window, by the m + 2 nonzero scalars a set and
        not the N + 2 points: the zero digits take no slot and no add."""
        return window_bits(self.m + 2, self.ctx.fused.total_bits)

    def proofs_dev(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Coefficient rows (8, k, n) Montgomery -> every cell's proof
        (3, L, k, N) Jacobian, cells in the specs' order.  The C^_v are
        computed on the card: the transform's MSM takes complete adds."""
        ctx = self.ctx
        scalars = self.column_scalars(coeffs)
        with span("fk20.msm"):
            chat = ctx.msm_grouped_prepared(self.table, scalars)  # (3,L,N,k)
        with span("fk20.g1_dft"):
            table, sc = self.transform_inputs(chat)
            return ctx.msm_grouped_prepared(table, sc, complete=True,
                                            c=self.transform_c)


def cells_to_bytes(cells: torch.Tensor) -> list:
    """Cells (8, ..., l) canonical words -> the specs' ``Cell`` of each,
    its l values 32 bytes big-endian each, in the cells' order.  The words
    are put in that byte order where they are (on the card: four
    elementwise ops), then read back once."""
    l = cells.shape[-1]
    w = cells.reshape(8, -1).flip(0).t()            # most significant first
    w = ((w >> 24) & 0xFF) | ((w >> 8) & 0xFF00) | ((w & 0xFF00) << 8) \
        | (w << 24)
    raw = to_words(w.contiguous()).tobytes()
    size = 32 * l
    return [raw[i:i + size] for i in range(0, len(raw), size)]


def cells_core(srs, n: int, l: int) -> CellsDeviceCore:
    """The core of (n, l) kept with ``srs``: its set-up table is built once
    a process."""
    key = (n, l)
    if key not in srs.cell_cores:
        srs.cell_cores[key] = CellsDeviceCore(srs, n, l)
    return srs.cell_cores[key]
