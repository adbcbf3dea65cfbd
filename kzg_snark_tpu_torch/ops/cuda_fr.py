"""Wrappers of the field and curve kernels, with their plain versions.

Counterpart of ``kzg_snark_tpu/ops/pallas_fr.py``:

* K1 ``fr_mul`` (and ``fr_add`` / ``fr_sub`` from the same source file),
  ``csrc/fr_kernels.cu``;
* K6 ``g1_add``, K7 ``g1_double`` and K9 ``g1_add_mixed``,
  ``csrc/curve_kernels.cu``; K7 with K6's add as the small MSM uses them,
  the whole double-and-add ladder in one launch: ``g1_ladder``.

A wrapper given CPU tensors runs the plain PyTorch version; given CUDA
tensors it launches the kernel or raises.  Plain versions also take CUDA
tensors when called directly (the on-card comparison does so).

Every function takes L = ``fc.num_limbs`` words an element: (L, n)
fields and (3, L, m) points, L = 8 or 12 (``ops/limbs.py``).

Plain arithmetic: torch has no unsigned shifts on the CPU, so the digit
arithmetic widens the 32-bit limbs to int64: additions ripple carries
over L words; products split words into 2 L 16-bit halves (a column of
at most 2 x 24 16 x 16-bit products, with its carries, stays below 2^41)
and reduce with word-serial Montgomery steps of 16 bits.  CUDA tensors
and CPU batches of more than ``INT_COLUMNS`` elements take it; smaller
CPU batches take exact Python integers: the same values in a few torch
ops where the digits take 100 to 180, which set the time of small
batches (the bit-serial MSMs' curve formulas).
"""

from __future__ import annotations

import torch

from ..utils.build import check, count_launch, cuda_lib
from .limbs import FieldConsts

M16 = 0xFFFF
M32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# Plain field arithmetic.  Inputs (L, ...) int32 broadcastable against each
# other along the batch dims; outputs (L, *batch) int32.
# ---------------------------------------------------------------------------


def _flat_pair(a: torch.Tensor, b: torch.Tensor):
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    return a.reshape(shape[0], -1), b.reshape(shape[0], -1), shape


def _wide(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.int64) & M32


def _narrow(w: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 with the same bits."""
    return ((w ^ 0x80000000) - 0x80000000).to(torch.int32)


def _ripple32(s: torch.Tensor):
    """Carry-normalize word sums along dim 1 of (K, L, N) int64; returns
    (words in [0, 2^32), signed carry out of the top word) per K."""
    words = []
    carry = torch.zeros_like(s[:, 0])
    for i in range(s.shape[1]):
        v = s[:, i] + carry
        words.append(v & M32)
        carry = v >> 32
    return torch.stack(words, dim=1), carry


INT_COLUMNS = 1 << 14


def _by_ints(a: torch.Tensor) -> bool:
    """Whether a flat (L, n) operand takes the Python-integer path."""
    return a.device.type == "cpu" and 0 < a.shape[1] <= INT_COLUMNS


def _int_op(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor, op: str,
            n_add: int = 0) -> torch.Tensor:
    """(L, n) a (op) b over Python ints: op "mul" (Montgomery), "add",
    "sub", or "addsub" (columns [0, n_add) added, the rest subtracted)."""
    n, nb, p = a.shape[1], 4 * fc.num_limbs, fc.modulus
    buf = torch.cat([a, b], dim=1).t().contiguous().numpy().tobytes()
    v = [int.from_bytes(buf[i:i + nb], "little")
         for i in range(0, len(buf), nb)]
    x, y = v[:n], v[n:]
    if op == "mul":
        r_inv = fc.r_inv
        out = [u * w % p * r_inv % p for u, w in zip(x, y)]
    else:
        k = n if op == "add" else n_add if op == "addsub" else 0
        out = [(u + w) % p for u, w in zip(x[:k], y[:k])] + \
            [(u - w) % p for u, w in zip(x[k:], y[k:])]
    data = b"".join(u.to_bytes(nb, "little") for u in out)
    return torch.frombuffer(bytearray(data), dtype=torch.int32).reshape(
        n, fc.num_limbs).t().contiguous()


def add_plain(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    a, b, shape = _flat_pair(a, b)
    if _by_ints(a):
        return _int_op(fc, a, b, "add").reshape(shape)
    p = fc.tensors(a.device)["p32"]
    s = _wide(a) + _wide(b)
    words, carry = _ripple32(torch.stack([s, s - p]))
    out = torch.where(carry[1] < 0, words[0], words[1])
    return _narrow(out).reshape(shape)


def sub_plain(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    a, b, shape = _flat_pair(a, b)
    if _by_ints(a):
        return _int_op(fc, a, b, "sub").reshape(shape)
    p = fc.tensors(a.device)["p32"]
    d = _wide(a) - _wide(b)
    words, carry = _ripple32(torch.stack([d, d + p]))
    out = torch.where(carry[0] < 0, words[1], words[0])
    return _narrow(out).reshape(shape)


def _split16(w: torch.Tensor) -> torch.Tensor:
    """(L, N) int64 words -> (2 L, N) 16-bit limbs."""
    return torch.stack([w & M16, w >> 16], dim=1).reshape(2 * w.shape[0], -1)


_COL_INDEX: dict[tuple[int, str], torch.Tensor] = {}


def _col_index(digits: int, device) -> torch.Tensor:
    """Column i + j of the digit product i, j: (digits^2,)."""
    key = (digits, str(device))
    if key not in _COL_INDEX:
        i = torch.arange(digits)
        _COL_INDEX[key] = (i[:, None] + i[None, :]).reshape(-1).to(device)
    return _COL_INDEX[key]


_MUL_CHUNK = 1 << 15   # columns per pass: bounds the (2 L, 2 L, N) product


def mul_plain(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    """Montgomery product a b R^-1 mod p (the K1 plain version)."""
    a, b, shape = _flat_pair(a, b)
    if _by_ints(a):
        return _int_op(fc, a, b, "mul").reshape(shape)
    if a.shape[1] > _MUL_CHUNK:
        return torch.cat([_mul_flat(fc, a[:, i:i + _MUL_CHUNK],
                                    b[:, i:i + _MUL_CHUNK])
                          for i in range(0, a.shape[1], _MUL_CHUNK)],
                         dim=1).reshape(shape)
    return _mul_flat(fc, a, b).reshape(shape)


def _mul_flat(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    consts = fc.tensors(a.device)
    n = a.shape[1]
    L = fc.num_limbs
    D = 2 * L                               # 16-bit digits an element
    A = _split16(_wide(a))
    B = _split16(_wide(b))
    prod = (A[:, None, :] * B[None, :, :]).reshape(D * D, n)
    t = torch.zeros((2 * D + 1, n), dtype=torch.int64, device=a.device)
    t.index_add_(0, _col_index(D, a.device), prod)
    p16 = consts["p16"]
    n0 = fc.n0_16
    rows = t.unbind(0)
    for i in range(D):
        m = (rows[i] * n0) & M16            # t_i < 2^41: no overflow
        t[i:i + D].addcmul_(m, p16)
        rows[i + 1].add_(rows[i] >> 16)
    # Columns D..2D-1 hold the result (< 2p < R) in uncarried 16-bit digits
    # below 2^41: pair them into 32-bit-weighted sums (< 2^58) and ripple.
    hi = t[D:2 * D].reshape(L, 2, n)
    w = hi[:, 0] + (hi[:, 1] << 16)
    words, carry = _ripple32(torch.stack([w, w - consts["p32"]]))
    out = torch.where(carry[1] < 0, words[0], words[1])
    return _narrow(out)


def addsub_plain(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor,
                 n_add: int) -> torch.Tensor:
    """(L, N) columns [0, n_add) get a + b mod p, the rest a - b mod p: the
    add_plain and sub_plain values, in one pass."""
    n = a.shape[1]
    if _by_ints(a):
        return _int_op(fc, a, b, "addsub", n_add)
    p = fc.tensors(a.device)["p32"]
    add = torch.arange(n, device=a.device) < n_add
    sign = torch.where(add, 1, -1)
    d = _wide(a) + _wide(b) * sign
    words, carry = _ripple32(torch.stack([d, d - p * sign]))
    second = torch.where(add, carry[1] >= 0, carry[0] < 0)
    return _narrow(torch.where(second, words[1], words[0]))


class PlainField:
    """Field ops over plain PyTorch, in the interface the curve formulas
    use (also by the field backend on CPU tensors).

    ``muls`` and ``addsubs`` evaluate several independent ops of one level
    of a formula in one call on their operands laid side by side; the
    values are those of one call each, and at small batches, where the
    cost is the number of torch ops, a formula takes about half the ops."""

    def __init__(self, fc: FieldConsts):
        self.fc = fc

    def mul(self, a, b):
        return mul_plain(self.fc, a, b)

    def square(self, a):
        return mul_plain(self.fc, a, a)

    def add(self, a, b):
        return add_plain(self.fc, a, b)

    def sub(self, a, b):
        return sub_plain(self.fc, a, b)

    def double(self, a):
        return add_plain(self.fc, a, a)

    def neg(self, a):
        return sub_plain(self.fc, torch.zeros_like(a), a)

    def is_zero(self, a):
        return (a == 0).all(dim=0)

    def one_like(self, a):
        one = self.fc.tensors(a.device)["one"]
        return one.reshape((a.shape[0],) + (1,) * (a.dim() - 1)).expand(
            a.shape)

    @staticmethod
    def _side_by_side(pairs):
        shapes = [a.shape if a.shape == b.shape else
                  torch.broadcast_shapes(a.shape, b.shape) for a, b in pairs]
        flat = lambda i: torch.cat(  # noqa: E731
            [ab[i].expand(s).reshape(s[0], -1)
             for ab, s in zip(pairs, shapes)], dim=1)
        return flat(0), flat(1), shapes

    @staticmethod
    def _split(out, shapes):
        sizes = [int(torch.Size(s[1:]).numel()) for s in shapes]
        return [o.reshape(s) for o, s in
                zip(torch.split(out, sizes, dim=1), shapes)]

    def muls(self, *pairs):
        """[a b R^-1 mod p for (a, b) in pairs]."""
        if len(pairs) == 1:
            return [self.mul(*pairs[0])]
        a, b, shapes = self._side_by_side(pairs)
        return self._split(mul_plain(self.fc, a, b), shapes)

    def addsubs(self, adds=(), subs=()):
        """[a + b for (a, b) in adds] + [a - b for (a, b) in subs]."""
        pairs = list(adds) + list(subs)
        if len(pairs) == 1:
            return [self.add(*pairs[0]) if adds else self.sub(*pairs[0])]
        a, b, shapes = self._side_by_side(pairs)
        if not subs:
            out = add_plain(self.fc, a, b)
        elif not adds:
            out = sub_plain(self.fc, a, b)
        else:
            n_add = sum(int(torch.Size(s[1:]).numel())
                        for s in shapes[:len(adds)])
            out = addsub_plain(self.fc, a, b, n_add)
        return self._split(out, shapes)


# ---------------------------------------------------------------------------
# Plain curve formulas (ops/regcurve.py order).  Points are (3, L, ...)
# int32; the identity is Z = 0.  Each step lists the independent ops of one
# level of the formula.
# ---------------------------------------------------------------------------


def double_formula(f, P):
    """dbl-2009-l; the identity maps to Z3 = 0."""
    X, Y, Z = P[0], P[1], P[2]
    A, B, YZ = f.muls((X, X), (Y, Y), (Y, Z))
    XB, A2, Z3 = f.addsubs(adds=[(X, B), (A, A), (YZ, YZ)])
    C, t = f.muls((B, B), (XB, XB))
    E, C2, tA = f.addsubs(adds=[(A2, A), (C, C)], subs=[(t, A)])
    (F,) = f.muls((E, E))
    C4, u = f.addsubs(adds=[(C2, C2)], subs=[(tA, C)])
    D, C8 = f.addsubs(adds=[(u, u), (C4, C4)])
    (D2,) = f.addsubs(adds=[(D, D)])
    (X3,) = f.addsubs(subs=[(F, D2)])
    (dx,) = f.addsubs(subs=[(D, X3)])
    (EY,) = f.muls((E, dx))
    (Y3,) = f.addsubs(subs=[(EY, C8)])
    return torch.stack([X3, Y3, Z3])


def add_formula(f, P, Q):
    """Complete Jacobian + Jacobian (RegCurve.add / CurveOps.add_xla)."""
    X1, Y1, Z1 = P[0], P[1], P[2]
    X2, Y2, Z2 = Q[0], Q[1], Q[2]
    Z1Z1, Z2Z2, Y1Z2, Y2Z1 = f.muls((Z1, Z1), (Z2, Z2), (Y1, Z2), (Y2, Z1))
    U1, U2, S1, S2 = f.muls((X1, Z2Z2), (X2, Z1Z1), (Y1Z2, Z2Z2),
                            (Y2Z1, Z1Z1))
    zs0, H, Rr = f.addsubs(adds=[(Z1, Z2)], subs=[(U2, U1), (S2, S1)])
    HH, zs = f.muls((H, H), (zs0, zs0))
    HH2, r2, zs1 = f.addsubs(adds=[(HH, HH), (Rr, Rr)], subs=[(zs, Z1Z1)])
    I, zs2 = f.addsubs(adds=[(HH2, HH2)], subs=[(zs1, Z2Z2)])
    J, V, r2sq, Z3 = f.muls((H, I), (U1, I), (r2, r2), (zs2, H))
    V2, x0 = f.addsubs(adds=[(V, V)], subs=[(r2sq, J)])
    (X3,) = f.addsubs(subs=[(x0, V2)])
    (vx,) = f.addsubs(subs=[(V, X3)])
    RV, S1J = f.muls((r2, vx), (S1, J))
    (S1J2,) = f.addsubs(adds=[(S1J, S1J)])
    (Y3,) = f.addsubs(subs=[(RV, S1J2)])
    out = torch.stack([X3, Y3, Z3])
    p_inf = f.is_zero(Z1)
    q_inf = f.is_zero(Z2)
    h_zero = f.is_zero(H)
    r_zero = f.is_zero(Rr)
    finite = ~p_inf & ~q_inf
    one = f.one_like(X3)
    ident = torch.stack([one, one, torch.zeros_like(Z3)])
    same = h_zero & r_zero & finite
    if bool(same.any()):        # the doubling only where a lane needs it
        out = torch.where(same[None, None], double_formula(f, P), out)
    out = torch.where((h_zero & ~r_zero & finite)[None, None], ident, out)
    out = torch.where(q_inf[None, None], P, out)
    out = torch.where(p_inf[None, None], Q, out)
    return out


def _madd_general(f, P, qx, qy):
    """madd-2007-bl: P + (qx, qy, 1); also returns H and Rr."""
    X1, Y1, Z1 = P[0], P[1], P[2]
    Z1Z1, qyZ1 = f.muls((Z1, Z1), (qy, Z1))
    U2, S2 = f.muls((qx, Z1Z1), (qyZ1, Z1Z1))
    H, Rr = f.addsubs(subs=[(U2, X1), (S2, Y1)])
    (HH,) = f.muls((H, H))
    HH2, r2, ZH = f.addsubs(adds=[(HH, HH), (Rr, Rr), (Z1, H)])
    r2sq, zh2 = f.muls((r2, r2), (ZH, ZH))
    I, zt = f.addsubs(adds=[(HH2, HH2)], subs=[(zh2, Z1Z1)])
    J, V = f.muls((H, I), (X1, I))
    V2, x0, Z3 = f.addsubs(adds=[(V, V)], subs=[(r2sq, J), (zt, HH)])
    (X3,) = f.addsubs(subs=[(x0, V2)])
    (vx,) = f.addsubs(subs=[(V, X3)])
    RV, Y1J = f.muls((r2, vx), (Y1, J))
    (Y1J2,) = f.addsubs(adds=[(Y1J, Y1J)])
    (Y3,) = f.addsubs(subs=[(RV, Y1J2)])
    return torch.stack([X3, Y3, Z3]), H, Rr


def add_mixed_fast_formula(f, P, qx, qy):
    """Incomplete mixed add (RegCurve.add_mixed_fast): P == q gives the
    identity instead of 2q."""
    out, _, _ = _madd_general(f, P, qx, qy)
    qx, qy = torch.broadcast_to(qx, out[0].shape), torch.broadcast_to(
        qy, out[0].shape)
    qpt = torch.stack([qx, qy, f.one_like(qx)])
    return torch.where(f.is_zero(P[2])[None, None], qpt, out)


def add_mixed_formula(f, P, qx, qy):
    """Complete mixed add (RegCurve.add_mixed); q finite."""
    out, H, Rr = _madd_general(f, P, qx, qy)
    p_inf = f.is_zero(P[2])
    h_zero = f.is_zero(H)
    r_zero = f.is_zero(Rr)
    one = f.one_like(out[0])
    ident = torch.stack([one, one, torch.zeros_like(out[2])])
    same = h_zero & r_zero & ~p_inf
    if bool(same.any()):
        out = torch.where(same[None, None], double_formula(f, P), out)
    out = torch.where((h_zero & ~r_zero & ~p_inf)[None, None], ident, out)
    qx, qy = torch.broadcast_to(qx, out[0].shape), torch.broadcast_to(
        qy, out[0].shape)
    qpt = torch.stack([qx, qy, one])
    return torch.where(p_inf[None, None], qpt, out)


def g1_add_plain(fc: FieldConsts, p: torch.Tensor, q: torch.Tensor
                 ) -> torch.Tensor:
    """K6 plain version: complete Jacobian add of (3, L, ...) batches."""
    return add_formula(PlainField(fc), p, q)


def g1_double_plain(fc: FieldConsts, p: torch.Tensor) -> torch.Tensor:
    """K7 plain version: Jacobian doubling of a (3, L, ...) batch."""
    return double_formula(PlainField(fc), p)


def g1_add_mixed_plain(fc: FieldConsts, p: torch.Tensor, qx: torch.Tensor,
                       qy: torch.Tensor) -> torch.Tensor:
    """K9 plain version: complete p + (qx, qy, 1) on a (3, L, m) batch;
    qx, qy (L, qn) with qn dividing m, point i taking column i % qn."""
    reps = p.shape[2] // qx.shape[1]
    return add_mixed_formula(PlainField(fc), p, qx.repeat(1, reps),
                             qy.repeat(1, reps))


LADDER_POINTS = 256     # most points of a summed ladder (one block a set)


def _top_row(words: torch.Tensor) -> int:
    """Bit rows up to the highest set bit of any (k, S, sp) int64 word."""
    for w in range(words.shape[1] - 1, -1, -1):
        top = int(words[:, w].max()) if words.numel() else 0
        if top:
            return 32 * w + top.bit_length()
    return 0


def g1_ladder_plain(fc: FieldConsts, points: torch.Tensor,
                    scalars: torch.Tensor, tree: bool = True
                    ) -> torch.Tensor:
    """K7 and K6 as the small MSM uses them, plain: points (3, L, n),
    scalars (k, S, sp) canonical 32-bit words with sp = n or 1 (one scalar
    for every point) -> sum_i s_ji P_i (3, L, k), or every s_ji P_i
    (3, L, k, n) where ``tree`` is false.

    The row loop of the JAX ``_small_msm_core`` and ``CurveOps.scale``:
    for each bit row from the least significant up, acc = bit ? acc + base
    : acc and base = 2 base; rows past every scalar's highest set bit leave
    acc as it is and are not run.  Then ``CurveOps.tree_sum``'s halving
    tree along the points."""
    f = PlainField(fc)
    L, n = points.shape[1], points.shape[2]
    words = _wide(scalars)
    one = fc.tensors(points.device)["one"].reshape(L, 1, 1).expand(
        L, scalars.shape[0], n)
    ident = torch.stack([one, one, torch.zeros_like(one)])
    acc = ident
    base = points[:, :, None, :]
    for b in range(_top_row(words)):
        bit = (words[:, b // 32] >> (b % 32)) & 1             # (k, sp)
        taken = add_formula(f, acc, base)
        acc = torch.where((bit == 1)[None, None], taken, acc)
        base = double_formula(f, base)
    if not tree:
        return acc
    m = n
    while m > 1:
        if m % 2:
            acc = torch.cat([acc, ident[..., :1]], dim=-1)
            m += 1
        half = m // 2
        acc = add_formula(f, acc[..., :half], acc[..., half:])
        m = half
    return acc[..., 0].contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: operands must share one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


_EWISE_PLAIN = {"fr_mul": mul_plain, "fr_add": add_plain,
                "fr_sub": sub_plain}


def _ewise(name: str, fc: FieldConsts, a: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """(L, n) op (L, n); either operand may be (L, 1) and broadcast."""
    if _on_cpu(a, b):
        return _EWISE_PLAIN[name](fc, a, b)
    _require_cuda(name, a, b)
    L = fc.num_limbs
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != L or b.shape[0] != L:
        raise ValueError(f"{name}: expected ({L}, n) operands, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    n = max(a.shape[1], b.shape[1])
    if a.shape[1] not in (1, n) or b.shape[1] not in (1, n):
        raise ValueError(f"{name}: cannot broadcast {tuple(a.shape)} "
                         f"with {tuple(b.shape)}")
    out = torch.empty((L, n), dtype=torch.int32, device=a.device)
    fn = getattr(cuda_lib(), "kzg_" + name)
    count_launch(name, width=n, limbs=L)
    check(fn(a.data_ptr(), a.shape[1], int(a.shape[1] != 1),
             b.data_ptr(), b.shape[1], int(b.shape[1] != 1),
             out.data_ptr(), n, fc.ptr, _stream(a)), name)
    return out


def fr_mul(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1: Montgomery product."""
    return _ewise("fr_mul", fc, a, b)


def fr_add(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _ewise("fr_add", fc, a, b)


def fr_sub(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _ewise("fr_sub", fc, a, b)


def _points_check(name: str, fc: FieldConsts, *pts: torch.Tensor) -> int:
    _require_cuda(name, *pts)
    shape = pts[0].shape
    L = fc.num_limbs
    for p in pts:
        if p.dim() != 3 or p.shape[:2] != (3, L) or p.shape != shape:
            raise ValueError(f"{name}: expected equal (3, {L}, m) point "
                             f"batches, got {[tuple(x.shape) for x in pts]}")
    return shape[2]


def _chain_check(name: str, fc: FieldConsts) -> None:
    """K6 and K9 run the carry-chain product (csrc/chain.cuh), whose sums
    stay in their words for 2p + 2^(32 L - 30) < 2^(32 L): BN254 and
    BLS12-381 by a wide margin."""
    R = 1 << (32 * fc.num_limbs)
    if 2 * fc.modulus + (R >> 30) >= R:
        raise ValueError(f"{name}: a {fc.modulus.bit_length()}-bit modulus "
                         f"is too close to 2^{32 * fc.num_limbs - 1} for "
                         f"the carry-chain product")


def g1_add(fc: FieldConsts, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """K6: complete Jacobian add of two (3, L, m) batches."""
    if _on_cpu(p, q):
        return g1_add_plain(fc, p, q)
    m = _points_check("g1_add", fc, p, q)
    _chain_check("g1_add", fc)
    out = torch.empty_like(p)
    count_launch("g1_add", width=m, limbs=fc.num_limbs)
    check(cuda_lib().kzg_g1_add(p.data_ptr(), q.data_ptr(), out.data_ptr(),
                                m, fc.ptr, _stream(p)), "g1_add")
    return out


def g1_double(fc: FieldConsts, p: torch.Tensor) -> torch.Tensor:
    """K7: Jacobian doubling of a (3, L, m) batch."""
    if _on_cpu(p):
        return g1_double_plain(fc, p)
    m = _points_check("g1_double", fc, p)
    out = torch.empty_like(p)
    count_launch("g1_double", width=m, limbs=fc.num_limbs)
    check(cuda_lib().kzg_g1_double(p.data_ptr(), out.data_ptr(), m, fc.ptr,
                                   _stream(p)), "g1_double")
    return out


def g1_add_mixed(fc: FieldConsts, p: torch.Tensor, qx: torch.Tensor,
                 qy: torch.Tensor) -> torch.Tensor:
    """K9: complete p + (qx, qy, 1) of a (3, L, m) batch and (L, qn)
    affine planes, qn dividing m; point i takes column i % qn."""
    if _on_cpu(p, qx, qy):
        return g1_add_mixed_plain(fc, p, qx, qy)
    m = _points_check("g1_add_mixed", fc, p)
    _require_cuda("g1_add_mixed", p, qx, qy)
    _chain_check("g1_add_mixed", fc)
    qn = qx.shape[-1]
    if qx.shape != (fc.num_limbs, qn) or qy.shape != qx.shape or qn < 1 \
            or m % qn:
        raise ValueError(f"g1_add_mixed: q planes {tuple(qx.shape)} / "
                         f"{tuple(qy.shape)} do not tile {m} points")
    out = torch.empty_like(p)
    count_launch("g1_add_mixed", width=m,
                 limbs=fc.num_limbs)
    check(cuda_lib().kzg_g1_add_mixed(p.data_ptr(), qx.data_ptr(),
                                      qy.data_ptr(), qn, out.data_ptr(), m,
                                      fc.ptr, _stream(p)), "g1_add_mixed")
    return out


def g1_ladder(fc: FieldConsts, points: torch.Tensor, scalars: torch.Tensor,
              tree: bool = True) -> torch.Tensor:
    """K7 and K6 as the small MSM uses them, in one launch: points (3, L,
    n), scalars (k, S, sp) canonical 32-bit words with sp = n or 1 -> sum_i
    s_ji P_i (3, L, k), n at most ``LADDER_POINTS``; with ``tree`` false
    every s_ji P_i (3, L, k, n), any n.  The representatives of
    ``g1_ladder_plain``."""
    if _on_cpu(points, scalars):
        return g1_ladder_plain(fc, points, scalars, tree)
    n = _points_check("g1_ladder", fc, points)
    _require_cuda("g1_ladder", points, scalars)
    _chain_check("g1_ladder", fc)
    if scalars.dim() != 3 or scalars.shape[1] < 1 \
            or scalars.shape[2] not in (1, n) \
            or not 1 <= n <= (LADDER_POINTS if tree else 1 << 30):
        raise ValueError(f"g1_ladder: scalars {tuple(scalars.shape)} for "
                         f"{n} points (tree {tree})")
    k, S, sp = scalars.shape
    L = fc.num_limbs
    out = torch.empty((3, L, k) if tree else (3, L, k, n),
                      dtype=torch.int32, device=points.device)
    count_launch("g1_ladder", width=n, limbs=L)
    check(cuda_lib().kzg_g1_ladder(points.data_ptr(), scalars.data_ptr(), S,
                                   sp, out.data_ptr(), n, k, int(tree),
                                   fc.ptr, _stream(points)), "g1_ladder")
    return out
