"""Expected answers of the ``cells`` protocol (EIP-7594
``compute_cells_and_kzg_proofs``), plain and independent of FK20.

Each blob's polynomial is given by its n values at w^0 .. w^(n-1).  Its
coefficients come from an inverse radix-2 transform and its 2n values on
the extended domain from a forward one, both over Python integers; cell i
holds the values at the bit-reversed positions i l .. i l + l - 1 (the
specs' ``coset_for_cell``).  Cell i's proof is [q_i(tau)] G1 with

    q_i(tau) = (p(tau) - I_i(tau)) / (tau^l - a_i),  a_i = z^l for z on the
    cell's coset,

I_i the cell's interpolation, evaluated at tau by the barycentric formula
over its l points: I(tau) = (tau^l - a) / (l a) sum_j y_j z_j / (tau - z_j).
p(tau) is the same barycentric sum over the blob's n values as the other
protocols' commitments (``Reference.at_tau``).
"""

from __future__ import annotations

import numpy as np

from .curves import root_of_unity
from .reference import Reference, words_to_limbs16

FIELD_ELEMENTS_PER_CELL = 64        # EIP-7594


def cell_width(n: int) -> int:
    """Values a cell: the specs' 64, cut to n / 4 only where n is too small
    to hold it (the CPU tests' tiny polynomials)."""
    return min(FIELD_ELEMENTS_PER_CELL, n // 4)


def _bit_reverse(n: int) -> list:
    bits = n.bit_length() - 1
    return [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
            for i in range(n)]


def radix2(values: list, w: int, r: int) -> list:
    """out[i] = sum_j values[j] w^(i j) mod r: iterative radix-2,
    decimation in time on the bit-reversed input."""
    n = len(values)
    rev = _bit_reverse(n)
    a = [values[rev[i]] for i in range(n)]
    size = 2
    while size <= n:
        half = size // 2
        step = pow(w, n // size, r)
        tw = [1] * half
        for j in range(1, half):
            tw[j] = tw[j - 1] * step % r
        for start in range(0, n, size):
            for j in range(half):
                x = a[start + j]
                y = a[start + j + half] * tw[j] % r
                a[start + j] = (x + y) % r
                a[start + j + half] = (x - y) % r
        size *= 2
    return a


def _words_to_ints(words: np.ndarray) -> list:
    """(8, n) canonical uint32 words -> n ints."""
    le = np.ascontiguousarray(np.asarray(words, dtype="<u4").T)
    buf = le.tobytes()
    return [int.from_bytes(buf[32 * i:32 * i + 32], "little")
            for i in range(le.shape[0])]


def _domain(ref: Reference, l: int) -> dict:
    """What every blob of one reference shares for cells of l: the roots,
    the cells' order and the barycentric weights z / (tau - z) on the
    extended domain."""
    cache = ref.__dict__.setdefault("_cells", {}).setdefault(l, {})
    if cache:
        return cache
    curve, n, r, tau = ref.curve, ref.n, ref.curve.r, ref.tau
    w2 = root_of_unity(curve, 2 * n)
    z = [1] * (2 * n)
    for e in range(1, 2 * n):
        z[e] = z[e - 1] * w2 % r
    d = [(tau - x) % r for x in z]
    if 0 in d:
        raise ValueError("tau lies on the extended domain")
    prefix = [1] * (2 * n + 1)
    for e in range(2 * n):
        prefix[e + 1] = prefix[e] * d[e] % r
    inv = pow(prefix[-1], -1, r)
    weight = [0] * (2 * n)
    for e in range(2 * n - 1, -1, -1):
        weight[e] = z[e] * prefix[e] % r * inv % r
        inv = inv * d[e] % r
    cache.update(l=l, w=root_of_unity(curve, n), w2=w2, z=z, weight=weight,
                 order=_bit_reverse(2 * n), n_inv=pow(n, -1, r),
                 tau_l=pow(tau, l, r))
    return cache


def expected(ref: Reference, words: np.ndarray, width: int | None = None
             ) -> dict:
    """Blobs (8, k, n) canonical words -> {"commitments", "evaluations",
    "proofs"}: per blob its commitment, then its 2n / l cells (l = ``width``,
    by default ``cell_width(n)``) as the specs' bytes (32 bytes big-endian a
    value) and their proofs, cell by cell."""
    curve, n, r = ref.curve, ref.n, ref.curve.r
    D = _domain(ref, width or cell_width(n))
    l, order = D["l"], D["order"]
    at_tau = ref.at_tau(words_to_limbs16(words))
    commitments = [ref.g.mul(t) for t in at_tau]
    w_inv = pow(D["w"], -1, r)
    evaluations, proofs = [], []
    for b in range(words.shape[1]):
        values = _words_to_ints(words[:, b, :])
        coeffs = [c * D["n_inv"] % r for c in radix2(values, w_inv, r)]
        ext = radix2(coeffs + [0] * n, D["w2"], r)
        for i in range(2 * n // l):
            pos = order[i * l:(i + 1) * l]
            ys = [ext[e] for e in pos]
            evaluations.append(b"".join(y.to_bytes(32, "big") for y in ys))
            a = pow(D["z"][pos[0]], l, r)
            zt = (D["tau_l"] - a) % r
            s = sum(y * D["weight"][e] for y, e in zip(ys, pos)) % r
            interp = zt * pow(l * a, -1, r) % r * s % r
            q = (at_tau[b] - interp) * pow(zt, -1, r) % r
            proofs.append(ref.g.mul(q))
    return {"commitments": commitments, "evaluations": evaluations,
            "proofs": proofs}
