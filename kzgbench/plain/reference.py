"""The plain reference: what each answer of a batch must be, from the inputs
and tau alone.

A polynomial is given by its values v_k at the domain points w^k.  Its value
anywhere is the barycentric sum p(x) = (x^n - 1) / n * sum_k v_k w^k / (x -
w^k) (and v_j at x = w^j), so

* the commitment to p is [p(tau)] G1, the same point as sum_i c_i [tau^i] G1
  over the coefficients c = iNTT(v) that the program commits;
* the evaluation at z is p(z);
* the opening proof at z is [(p(tau) - p(z)) / (tau - z)] G1, the commitment
  to the witness (p - p(z)) / (X - z); a batch's combined proof is the
  same with sum_i xi^(i+1) p_i.

The sums run over Python integers for the weights and over float64 matrix
products of 16-bit limbs for the n-term dot products: every partial sum is
an integer below n 2^32 <= 2^52, so float64 holds it exactly.  Nothing here
imports the program or takes anything it made: the reference sees the
inputs (the pool's canonical words, made by the benchmark) and tau.
"""

from __future__ import annotations

from itertools import accumulate

import numpy as np

from .curves import Curve, FixedBase, root_of_unity

MAX_N = 1 << 20             # float64 sums stay exact up to here


def ints_to_limbs16(values: list) -> np.ndarray:
    """Ints below 2^256 -> (len, 16) float64 little-endian 16-bit limbs."""
    buf = b"".join(v.to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, dtype="<u2").reshape(-1, 16).astype(np.float64)


def words_to_limbs16(words: np.ndarray) -> np.ndarray:
    """(8, ..., n) uint32 canonical words -> (..., n, 16) float64 limbs."""
    w = np.moveaxis(np.asarray(words, dtype="<u4"), 0, -1)
    w = np.ascontiguousarray(w)
    return w.view("<u2").astype(np.float64)


def limb_dot(values16: np.ndarray, weights16: np.ndarray, r: int) -> list:
    """sum_k v_k w_k mod r for each row of values16 (..., n, 16) against
    weights16 (n, 16) -> a flat list of ints."""
    n = weights16.shape[0]
    if n > MAX_N:
        raise ValueError(f"n = {n}: float64 sums are exact up to {MAX_N}")
    rows = values16.reshape(-1, n, 16)
    out = []
    for v in rows:
        m = (v.T @ weights16).astype(np.int64)          # (16, 16), exact
        diag = np.zeros(31, dtype=np.int64)
        for i in range(16):
            diag[i:i + 16] += m[i]
        out.append(sum(int(d) << (16 * k) for k, d in enumerate(diag)) % r)
    return out


class Domain:
    """The n-point domain of one curve's Fr and barycentric weights on it."""

    def __init__(self, curve: Curve, n: int):
        self.curve, self.n, r = curve, n, curve.r
        w = root_of_unity(curve, n)
        self.points = list(accumulate([w] * (n - 1), lambda a, b: a * b % r,
                                      initial=1))
        self.n_inv = pow(n, -1, r)

    def weights(self, x: int) -> tuple[np.ndarray, int]:
        """(W16, c) with p(x) = c * sum_k v_k W_k for any p given by its
        values v on the domain."""
        r = self.curve.r
        x %= r
        d = [(x - w) % r for w in self.points]
        if 0 in d:                                      # x = w^j: p(x) = v_j
            hot = [0] * self.n
            hot[d.index(0)] = 1
            return ints_to_limbs16(hot), 1
        mul = lambda a, b: a * b % r                    # noqa: E731
        prefix = list(accumulate(d, mul))               # d_0 ... d_k
        suffix_inv = list(accumulate(reversed(d[1:]), mul,
                                     initial=pow(prefix[-1], -1, r)))
        suffix_inv.reverse()                            # 1 / (d_k ... d_n-1)
        inv = [suffix_inv[0]] + [a * b % r for a, b in
                                 zip(prefix[:-1], suffix_inv[1:])]
        W = [w * i % r for w, i in zip(self.points, inv)]
        c = (pow(x, self.n, r) - 1) * self.n_inv % r
        return ints_to_limbs16(W), c


class Reference:
    """Expected answers of one configuration at one tau."""

    def __init__(self, curve: Curve, n: int, tau: int):
        self.curve, self.n, self.tau = curve, n, tau % curve.r
        self.domain = Domain(curve, n)
        self.tau_w, self.tau_c = self.domain.weights(self.tau)
        self.g = FixedBase(curve)

    def evaluate(self, values16: np.ndarray, x: int) -> list:
        W, c = self.domain.weights(x)
        r = self.curve.r
        return [c * v % r for v in limb_dot(values16, W, r)]

    def at_tau(self, values16: np.ndarray) -> list:
        r = self.curve.r
        return [self.tau_c * v % r
                for v in limb_dot(values16, self.tau_w, r)]

    def quotient(self, at_tau: int, at_z: int, z: int) -> int:
        r = self.curve.r
        return (at_tau - at_z) * pow((self.tau - z) % r, -1, r) % r
