"""Host-side elliptic-curve group operations (projective coordinates).

Plays the role of py_ecc's ``optimized_bn128`` / ``optimized_bls12_381``
modules in the reference (``kzg.py:26-49``).  Points are
3-tuples ``(X, Y, Z)`` of field elements in standard projective coordinates
(x = X/Z, y = Y/Z), the identity is ``(1, 1, 0)``, and the doubling/addition
formulas produce the same projective *representatives* py_ecc's formulas do.

That representative-level fidelity matters: the reference's Fiat-Shamir
transcript hashes ``str()`` of the non-normalized projective tuple
(``transcript.py:80-85`` fallback), so commitments only hash
identically if every intermediate doubling/addition chain produces identical
coordinates.  See ``transcript.py`` for how points serialize.

All functions are generic over the coordinate field: plain GF(p) elements
for G1, Fq2 elements for G2, Fq12 elements for pairing-side computations
(the tower classes in ``tower.py`` implement the same operator protocol).
"""

from __future__ import annotations


def identity(field):
    """The point at infinity, py_ecc's Z1/Z2 convention: (1, 1, 0)."""
    return (field.one(), field.one(), field.zero())


def is_identity(pt) -> bool:
    return not bool(pt[2])


def double(pt):
    """Projective doubling; same formula family (and hence the same output
    representative) as py_ecc's optimized ``double`` (behavior mirrored from
    kzg.py's backend, not copied code)."""
    x, y, z = pt
    W = x * x * 3
    S = y * z
    B = x * y * S
    H = W * W - B * 8
    S_squared = S * S
    newx = H * S * 2
    newy = W * (B * 4 - H) - y * y * S_squared * 8
    newz = S * S_squared * 8
    return (newx, newy, newz)


def add(p1, p2):
    """Projective addition matching py_ecc's ``add`` branch structure:
    identity short-circuits, doubling dispatch on equal points, and the
    U/V-based general case producing identical representatives."""
    one = p1[0].one()
    zero = p1[0].zero()
    if not bool(p1[2]) or not bool(p2[2]):
        return p1 if not bool(p2[2]) else p2
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    U1 = y2 * z1
    U2 = y1 * z2
    V1 = x2 * z1
    V2 = x1 * z2
    if V1 == V2 and U1 == U2:
        return double(p1)
    if V1 == V2:
        return (one, one, zero)
    U = U1 - U2
    V = V1 - V2
    V_squared = V * V
    V_squared_times_V2 = V_squared * V2
    V_cubed = V * V_squared
    W = z1 * z2
    A = U * U * W - V_cubed - V_squared_times_V2 * 2
    newx = V * A
    newy = U * (V_squared_times_V2 - A) - V_cubed * U2
    newz = V_cubed * W
    return (newx, newy, newz)


def neg(pt):
    x, y, z = pt
    return (x, -y, z)


def multiply(pt, n: int):
    """Scalar multiplication with py_ecc's recursion shape (the exact
    double/add order determines the projective representative the reference
    transcript hashes).  Iterative rewrite of the same chain:
    mult(P, n) = add(mult(double(P), n // 2), P if n odd)."""
    if n == 0:
        return identity(type(pt[0]))
    if n == 1:
        return pt
    # Iterative unrolling of the LSB-first recursion
    # mult(P, n) = add(mult(double(P), n//2), P if n odd): repeatedly double
    # the base, record the doubled copies where odd bits occur, then perform
    # the adds in recursion-unwind (MSB-to-LSB) order.
    pending_adds = []
    q = pt
    while n > 1:
        if n & 1:
            pending_adds.append(q)
        q = double(q)
        n >>= 1
    result = q
    for point in reversed(pending_adds):
        result = add(result, point)
    return result


def eq(p1, p2) -> bool:
    """Projective equality by cross-multiplication (py_ecc ``eq``)."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    return x1 * z2 == x2 * z1 and y1 * z2 == y2 * z1


def normalize(pt):
    """Return the affine representative (x, y) or None for the identity."""
    x, y, z = pt
    if not bool(z):
        return None
    z_inv = z.inverse() if hasattr(z, "inverse") else 1 / z
    return (x * z_inv, y * z_inv)


def from_affine(field, xy):
    if xy is None:
        return identity(field)
    return (field(xy[0]) if not isinstance(xy[0], field) else xy[0],
            field(xy[1]) if not isinstance(xy[1], field) else xy[1],
            field.one())


def is_on_curve(pt, b) -> bool:
    """Projective curve membership: Y^2 Z == X^3 + b Z^3."""
    if is_identity(pt):
        return True
    x, y, z = pt
    return y * y * z == x * x * x + b * (z * z * z)
