"""Wrappers of the field and curve kernels, with their plain versions.

Counterpart of ``kzg_snark_tpu/ops/pallas_fr.py``:

* K1 ``fr_mul`` (and ``fr_add`` / ``fr_sub`` from the same source file),
  ``csrc/fr_kernels.cu``;
* K6 ``g1_add`` and K7 ``g1_double``, ``csrc/curve_kernels.cu``.

A wrapper given CPU tensors runs the plain PyTorch version; given CUDA
tensors it launches the kernel or raises.  Plain versions also take CUDA
tensors when called directly (the on-card comparison does so).

Plain arithmetic: torch has no unsigned shifts on the CPU, so the plain
versions widen the 32-bit limbs to int64.  Additions ripple carries over
8 words; products split words into 16-bit halves (a 16 x 16-bit product
and a column of 32 of them fit int64) and reduce with word-serial
Montgomery steps of 16 bits.
"""

from __future__ import annotations

import torch

from ..utils.build import check, count_launch, cuda_lib
from .limbs import NUM_LIMBS, FieldConsts

M16 = 0xFFFF
M32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# Plain field arithmetic.  Inputs (8, ...) int32 broadcastable against each
# other along the batch dims; outputs (8, *batch) int32.
# ---------------------------------------------------------------------------


def _flat_pair(a: torch.Tensor, b: torch.Tensor):
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    return a.reshape(NUM_LIMBS, -1), b.reshape(NUM_LIMBS, -1), shape


def _wide(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.int64) & M32


def _narrow(w: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 with the same bits."""
    return ((w ^ 0x80000000) - 0x80000000).to(torch.int32)


def _ripple32(s: torch.Tensor):
    """Carry-normalize word sums along dim 1 of (K, 8, N) int64; returns
    (words in [0, 2^32), signed carry out of the top word) per K."""
    words = []
    carry = torch.zeros_like(s[:, 0])
    for i in range(NUM_LIMBS):
        v = s[:, i] + carry
        words.append(v & M32)
        carry = v >> 32
    return torch.stack(words, dim=1), carry


def add_plain(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    a, b, shape = _flat_pair(a, b)
    p = fc.tensors(a.device)["p32"]
    s = _wide(a) + _wide(b)
    words, carry = _ripple32(torch.stack([s, s - p]))
    out = torch.where(carry[1] < 0, words[0], words[1])
    return _narrow(out).reshape(shape)


def sub_plain(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    a, b, shape = _flat_pair(a, b)
    p = fc.tensors(a.device)["p32"]
    d = _wide(a) - _wide(b)
    words, carry = _ripple32(torch.stack([d, d + p]))
    out = torch.where(carry[0] < 0, words[1], words[0])
    return _narrow(out).reshape(shape)


def _split16(w: torch.Tensor) -> torch.Tensor:
    """(8, N) int64 words -> (16, N) 16-bit limbs."""
    return torch.stack([w & M16, w >> 16], dim=1).reshape(2 * NUM_LIMBS, -1)


_COL_INDEX: dict[str, torch.Tensor] = {}


def _col_index(device) -> torch.Tensor:
    key = str(device)
    if key not in _COL_INDEX:
        i = torch.arange(16)
        _COL_INDEX[key] = (i[:, None] + i[None, :]).reshape(-1).to(device)
    return _COL_INDEX[key]


_MUL_CHUNK = 1 << 15   # columns per pass: bounds the (16, 16, N) product


def mul_plain(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    """Montgomery product a b R^-1 mod p (the K1 plain version)."""
    a, b, shape = _flat_pair(a, b)
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
    A = _split16(_wide(a))
    B = _split16(_wide(b))
    prod = (A[:, None, :] * B[None, :, :]).reshape(256, n)
    t = torch.zeros((33, n), dtype=torch.int64, device=a.device)
    t.index_add_(0, _col_index(a.device), prod)
    p16 = consts["p16"]
    n0 = fc.n0_16
    rows = t.unbind(0)
    for i in range(16):
        m = (rows[i] * n0) & M16            # t_i < 2^40: no overflow
        t[i:i + 16].addcmul_(m, p16)
        rows[i + 1].add_(rows[i] >> 16)
    # Columns 16..31 hold the result (< 2p) in uncarried 16-bit digits
    # below 2^39: pair them into 32-bit-weighted sums (< 2^56) and ripple.
    hi = t[16:32].reshape(NUM_LIMBS, 2, n)
    w = hi[:, 0] + (hi[:, 1] << 16)
    words, carry = _ripple32(torch.stack([w, w - consts["p32"]]))
    out = torch.where(carry[1] < 0, words[0], words[1])
    return _narrow(out)


class PlainField:
    """Field ops over plain PyTorch, in the interface the curve formulas
    use (also by the field backend on CPU tensors)."""

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
        return one.reshape((NUM_LIMBS,) + (1,) * (a.dim() - 1)).expand(
            a.shape)


# ---------------------------------------------------------------------------
# Plain curve formulas (ops/regcurve.py order).  Points are (3, 8, ...)
# int32; the identity is Z = 0.
# ---------------------------------------------------------------------------


def double_formula(f, P):
    X, Y, Z = P[0], P[1], P[2]
    A = f.square(X)
    B = f.square(Y)
    C = f.square(B)
    t = f.square(f.add(X, B))
    D = f.double(f.sub(f.sub(t, A), C))
    E = f.add(f.double(A), A)
    F = f.square(E)
    X3 = f.sub(F, f.double(D))
    eight_c = f.double(f.double(f.double(C)))
    Y3 = f.sub(f.mul(E, f.sub(D, X3)), eight_c)
    Z3 = f.double(f.mul(Y, Z))
    return torch.stack([X3, Y3, Z3])


def add_formula(f, P, Q):
    """Complete Jacobian + Jacobian (RegCurve.add / CurveOps.add_xla)."""
    X1, Y1, Z1 = P[0], P[1], P[2]
    X2, Y2, Z2 = Q[0], Q[1], Q[2]
    Z1Z1 = f.square(Z1)
    Z2Z2 = f.square(Z2)
    U1 = f.mul(X1, Z2Z2)
    U2 = f.mul(X2, Z1Z1)
    S1 = f.mul(f.mul(Y1, Z2), Z2Z2)
    S2 = f.mul(f.mul(Y2, Z1), Z1Z1)
    H = f.sub(U2, U1)
    Rr = f.sub(S2, S1)
    HH = f.square(H)
    I = f.double(f.double(HH))
    J = f.mul(H, I)
    r2 = f.double(Rr)
    V = f.mul(U1, I)
    X3 = f.sub(f.sub(f.square(r2), J), f.double(V))
    Y3 = f.sub(f.mul(r2, f.sub(V, X3)), f.double(f.mul(S1, J)))
    zs = f.square(f.add(Z1, Z2))
    Z3 = f.mul(f.sub(f.sub(zs, Z1Z1), Z2Z2), H)
    out = torch.stack([X3, Y3, Z3])
    dbl = double_formula(f, P)
    p_inf = f.is_zero(Z1)
    q_inf = f.is_zero(Z2)
    h_zero = f.is_zero(H)
    r_zero = f.is_zero(Rr)
    finite = ~p_inf & ~q_inf
    one = f.one_like(X3)
    ident = torch.stack([one, one, torch.zeros_like(Z3)])
    out = torch.where((h_zero & r_zero & finite)[None, None], dbl, out)
    out = torch.where((h_zero & ~r_zero & finite)[None, None], ident, out)
    out = torch.where(q_inf[None, None], P, out)
    out = torch.where(p_inf[None, None], Q, out)
    return out


def _madd_general(f, P, qx, qy):
    X1, Y1, Z1 = P[0], P[1], P[2]
    Z1Z1 = f.square(Z1)
    U2 = f.mul(qx, Z1Z1)
    S2 = f.mul(f.mul(qy, Z1), Z1Z1)
    H = f.sub(U2, X1)
    Rr = f.sub(S2, Y1)
    HH = f.square(H)
    I = f.double(f.double(HH))
    J = f.mul(H, I)
    r2 = f.double(Rr)
    V = f.mul(X1, I)
    X3 = f.sub(f.sub(f.square(r2), J), f.double(V))
    Y3 = f.sub(f.mul(r2, f.sub(V, X3)), f.double(f.mul(Y1, J)))
    Z3 = f.sub(f.sub(f.square(f.add(Z1, H)), Z1Z1), HH)
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
    dbl = double_formula(f, P)
    p_inf = f.is_zero(P[2])
    h_zero = f.is_zero(H)
    r_zero = f.is_zero(Rr)
    one = f.one_like(out[0])
    ident = torch.stack([one, one, torch.zeros_like(out[2])])
    out = torch.where((h_zero & r_zero & ~p_inf)[None, None], dbl, out)
    out = torch.where((h_zero & ~r_zero & ~p_inf)[None, None], ident, out)
    qx, qy = torch.broadcast_to(qx, out[0].shape), torch.broadcast_to(
        qy, out[0].shape)
    qpt = torch.stack([qx, qy, one])
    return torch.where(p_inf[None, None], qpt, out)


def g1_add_plain(fc: FieldConsts, p: torch.Tensor, q: torch.Tensor
                 ) -> torch.Tensor:
    """K6 plain version: complete Jacobian add of (3, 8, ...) batches."""
    return add_formula(PlainField(fc), p, q)


def g1_double_plain(fc: FieldConsts, p: torch.Tensor) -> torch.Tensor:
    """K7 plain version: Jacobian doubling of a (3, 8, ...) batch."""
    return double_formula(PlainField(fc), p)


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
    """(8, n) op (8, n); either operand may be (8, 1) and broadcast."""
    if _on_cpu(a, b):
        return _EWISE_PLAIN[name](fc, a, b)
    _require_cuda(name, a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != NUM_LIMBS \
            or b.shape[0] != NUM_LIMBS:
        raise ValueError(f"{name}: expected (8, n) operands, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    n = max(a.shape[1], b.shape[1])
    if a.shape[1] not in (1, n) or b.shape[1] not in (1, n):
        raise ValueError(f"{name}: cannot broadcast {tuple(a.shape)} "
                         f"with {tuple(b.shape)}")
    out = torch.empty((NUM_LIMBS, n), dtype=torch.int32, device=a.device)
    fn = getattr(cuda_lib(), "kzg_" + name)
    count_launch(name)
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


def _points_check(name: str, *pts: torch.Tensor) -> int:
    _require_cuda(name, *pts)
    shape = pts[0].shape
    for p in pts:
        if p.dim() != 3 or p.shape[:2] != (3, NUM_LIMBS) or p.shape != shape:
            raise ValueError(f"{name}: expected equal (3, 8, m) point "
                             f"batches, got {[tuple(x.shape) for x in pts]}")
    return shape[2]


def g1_add(fc: FieldConsts, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """K6: complete Jacobian add of two (3, 8, m) batches."""
    if _on_cpu(p, q):
        return g1_add_plain(fc, p, q)
    m = _points_check("g1_add", p, q)
    out = torch.empty_like(p)
    count_launch("g1_add")
    check(cuda_lib().kzg_g1_add(p.data_ptr(), q.data_ptr(), out.data_ptr(),
                                m, fc.ptr, _stream(p)), "g1_add")
    return out


def g1_double(fc: FieldConsts, p: torch.Tensor) -> torch.Tensor:
    """K7: Jacobian doubling of a (3, 8, m) batch."""
    if _on_cpu(p):
        return g1_double_plain(fc, p)
    m = _points_check("g1_double", p)
    out = torch.empty_like(p)
    count_launch("g1_double")
    check(cuda_lib().kzg_g1_double(p.data_ptr(), out.data_ptr(), m, fc.ptr,
                                   _stream(p)), "g1_double")
    return out
