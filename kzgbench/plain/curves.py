"""The two curves on Python integers: constants, G1 arithmetic, encodings.

Plain code of the benchmark's own, independent of the program: the
constants are the curves' published parameters (BN254 as EIP-196 gives it,
BLS12-381 as the IETF pairing-friendly-curves draft and the Ethereum
consensus specs give it), the arithmetic is textbook Jacobian a = 0
formulas, and ``compress`` is each curve's compressed G1 encoding.  The
reference (``plain/reference.py``) and the harness's host protocol both use
it; it imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Curve:
    name: str
    p: int                  # base field modulus
    r: int                  # group order, the scalar field
    b: int                  # y^2 = x^3 + b
    g1: tuple               # affine generator (x, y)
    fr_generator: int       # generator of Fr*: the NTT domain is its powers
    point_bytes: int        # compressed G1 size


BN254 = Curve(
    name="bn254",
    p=0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47,
    r=0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001,
    b=3, g1=(1, 2), fr_generator=5, point_bytes=32)

BLS12_381 = Curve(
    name="bls12_381",
    p=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    r=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    b=4,
    g1=(0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
        0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1),
    fr_generator=7, point_bytes=48)

CURVES = {c.name: c for c in (BN254, BLS12_381)}


def root_of_unity(curve: Curve, n: int) -> int:
    """The primitive n-th root g^((r-1)/n) of Fr, g = ``fr_generator``: the
    domain [w^0, ..., w^(n-1)] the polynomials are given on (for BLS12-381
    at n = 4096 the consensus specs' ROOT_OF_UNITY, from 7)."""
    if (curve.r - 1) % n:
        raise ValueError(f"{n} does not divide r - 1")
    return pow(curve.fr_generator, (curve.r - 1) // n, curve.r)


# -- G1 on Jacobian coordinates (X, Y, Z), x = X/Z^2, y = Y/Z^3; Z = 0 is
#    the identity --------------------------------------------------------------

def jac_double(P, p: int):
    X, Y, Z = P
    if Z == 0 or Y == 0:
        return (1, 1, 0)
    A = X * X % p
    B = Y * Y % p
    C = B * B % p
    D = 2 * ((X + B) * (X + B) - A - C) % p
    E = 3 * A % p
    X3 = (E * E - 2 * D) % p
    Y3 = (E * (D - X3) - 8 * C) % p
    Z3 = 2 * Y * Z % p
    return (X3, Y3, Z3)


def jac_add(P, Q, p: int):
    if P[2] == 0:
        return Q
    if Q[2] == 0:
        return P
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1 = Z1 * Z1 % p
    Z2Z2 = Z2 * Z2 % p
    U1 = X1 * Z2Z2 % p
    U2 = X2 * Z1Z1 % p
    S1 = Y1 * Z2 * Z2Z2 % p
    S2 = Y2 * Z1 * Z1Z1 % p
    H = (U2 - U1) % p
    R = (S2 - S1) % p
    if H == 0:
        return jac_double(P, p) if R == 0 else (1, 1, 0)
    HH = H * H % p
    HHH = H * HH % p
    V = U1 * HH % p
    X3 = (R * R - HHH - 2 * V) % p
    Y3 = (R * (V - X3) - S1 * HHH) % p
    Z3 = Z1 * Z2 * H % p
    return (X3, Y3, Z3)


def jac_add_affine(P, q, p: int):
    """P (Jacobian) + q (affine, finite)."""
    if P[2] == 0:
        return (q[0], q[1], 1)
    X1, Y1, Z1 = P
    Z1Z1 = Z1 * Z1 % p
    U2 = q[0] * Z1Z1 % p
    S2 = q[1] * Z1 * Z1Z1 % p
    H = (U2 - X1) % p
    R = (S2 - Y1) % p
    if H == 0:
        return jac_double(P, p) if R == 0 else (1, 1, 0)
    HH = H * H % p
    HHH = H * HH % p
    V = X1 * HH % p
    X3 = (R * R - HHH - 2 * V) % p
    Y3 = (R * (V - X3) - Y1 * HHH) % p
    Z3 = Z1 * H % p
    return (X3, Y3, Z3)


def to_affine(P, p: int):
    """Jacobian -> (x, y), or None for the identity."""
    if P[2] == 0:
        return None
    zi = pow(P[2], -1, p)
    zi2 = zi * zi % p
    return (P[0] * zi2 % p, P[1] * zi2 * zi % p)


def batch_to_affine(points, p: int) -> list:
    """Many Jacobian points -> affine (None for the identity), one
    inversion for all (Montgomery's trick)."""
    zs = [P[2] for P in points]
    prefix, acc = [], 1
    for z in zs:
        prefix.append(acc)
        if z:
            acc = acc * z % p
    inv = pow(acc, -1, p)
    out = [None] * len(points)
    for i in range(len(points) - 1, -1, -1):
        z = zs[i]
        if not z:
            continue
        zi = prefix[i] * inv % p
        inv = inv * z % p
        zi2 = zi * zi % p
        X, Y, _ = points[i]
        out[i] = (X * zi2 % p, Y * zi2 * zi % p)
    return out


class FixedBase:
    """[s] G for the curve's generator by 8-bit windows over an affine table
    T[w][d] = d 2^(8 w) G: at most 32 mixed adds a scalar."""

    WINDOW = 8

    def __init__(self, curve: Curve):
        self.curve = curve
        p = curve.p
        c = self.WINDOW
        self.windows = -(-curve.r.bit_length() // c)
        base = (curve.g1[0], curve.g1[1], 1)
        jac = []
        for _ in range(self.windows):
            row = [base]
            for _ in range((1 << c) - 2):
                row.append(jac_add(row[-1], base, p))
            jac.extend(row)
            for _ in range(c):
                base = jac_double(base, p)
        flat = batch_to_affine(jac, p)
        per = (1 << c) - 1
        self.table = [flat[w * per:(w + 1) * per]
                      for w in range(self.windows)]

    def mul(self, s: int):
        """Affine [s] G, None for the identity."""
        s %= self.curve.r
        p = self.curve.p
        c, mask = self.WINDOW, (1 << self.WINDOW) - 1
        acc = (1, 1, 0)
        for w in range(self.windows):
            d = (s >> (c * w)) & mask
            if d:
                acc = jac_add_affine(acc, self.table[w][d - 1], p)
        return to_affine(acc, p)


def compress(a, curve: Curve) -> bytes:
    """Compressed G1: x big-endian in ``point_bytes`` bytes with flags in
    the top byte.  BLS12-381 as the consensus specs (ZCash's format): 0x80
    compressed, 0x40 infinity, 0x20 when y > (p - 1) / 2.  BN254 (x below
    2^254): 0x80 when y > (p - 1) / 2, 0x40 infinity."""
    size = curve.point_bytes
    if curve.name == "bls12_381":
        flag_c, flag_inf, flag_sign = 0x80, 0x40, 0x20
    else:
        flag_c, flag_inf, flag_sign = 0x00, 0x40, 0x80
    if a is None:
        return bytes([flag_c | flag_inf]) + bytes(size - 1)
    x, y = a
    out = bytearray(x.to_bytes(size, "big"))
    out[0] |= flag_c | (flag_sign if y > (curve.p - 1) // 2 else 0)
    return bytes(out)
