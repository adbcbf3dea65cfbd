"""Host-side extension-field towers for pairing computation.

Fq2 = Fq[u]/(u^2 + 1), Fq6 = Fq2[v]/(v^3 - xi), Fq12 = Fq6[w]/(w^2 - v).

Plays the role of py_ecc's FQ2/FQ12 classes, which back the reference's
``pairing`` calls (``kzg.py:208-209,285-287``).  Pairing
*outputs* are only ever compared for equality — never serialized into the
transcript — so the tower representation is free to differ from py_ecc's
(py_ecc uses a direct degree-12 extension); only mathematical correctness of
e(·,·) matters.

Component values are plain Python ints reduced mod p; classes are generated
per base prime via :func:`tower_fields` so both BN254 and BLS12-381 share the
implementation.
"""

from __future__ import annotations

_TOWER_CACHE: dict = {}


def tower_fields(p: int, xi: tuple[int, int]):
    """Build (Fq2, Fq6, Fq12) classes for base prime p and sextic twist
    non-residue xi = xi0 + xi1*u."""
    key = (p, xi)
    if key in _TOWER_CACHE:
        return _TOWER_CACHE[key]

    class Fq2:
        __slots__ = ("c0", "c1")
        P = p

        def __init__(self, c0=0, c1=0):
            if isinstance(c0, Fq2):
                c0, c1 = c0.c0, c0.c1
            self.c0 = c0 % p
            self.c1 = c1 % p

        @classmethod
        def one(cls):
            return cls(1, 0)

        @classmethod
        def zero(cls):
            return cls(0, 0)

        def __add__(self, o):
            o = _c2(o)
            return Fq2(self.c0 + o.c0, self.c1 + o.c1)

        __radd__ = __add__

        def __sub__(self, o):
            o = _c2(o)
            return Fq2(self.c0 - o.c0, self.c1 - o.c1)

        def __rsub__(self, o):
            return _c2(o) - self

        def __mul__(self, o):
            if isinstance(o, int):
                return Fq2(self.c0 * o, self.c1 * o)
            a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
            # (a0 + a1 u)(b0 + b1 u) with u^2 = -1
            t0 = a0 * b0
            t1 = a1 * b1
            return Fq2(t0 - t1, (a0 + a1) * (b0 + b1) - t0 - t1)

        __rmul__ = __mul__

        def __neg__(self):
            return Fq2(-self.c0, -self.c1)

        def conjugate(self):
            return Fq2(self.c0, -self.c1)

        def inverse(self):
            # 1/(a + bu) = (a - bu)/(a^2 + b^2)
            norm_inv = pow(self.c0 * self.c0 + self.c1 * self.c1, -1, p)
            return Fq2(self.c0 * norm_inv, -self.c1 * norm_inv)

        def __truediv__(self, o):
            return self * _c2(o).inverse()

        def __pow__(self, e: int):
            result, base = Fq2.one(), self
            if e < 0:
                base, e = self.inverse(), -e
            while e:
                if e & 1:
                    result = result * base
                base = base * base
                e >>= 1
            return result

        def __eq__(self, o):
            if isinstance(o, int):
                return self.c0 == o % p and self.c1 == 0
            return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

        def __hash__(self):
            return hash((p, self.c0, self.c1))

        def __bool__(self):
            return self.c0 != 0 or self.c1 != 0

        def __repr__(self):
            return f"Fq2({self.c0}, {self.c1})"

        def mul_by_nonresidue(self):
            """Multiply by xi (used to reduce v^3 in Fq6)."""
            return self * XI

    def _c2(o):
        return Fq2(o, 0) if isinstance(o, int) else o

    XI = Fq2(*xi)

    class Fq6:
        __slots__ = ("c0", "c1", "c2")

        def __init__(self, c0=None, c1=None, c2=None):
            self.c0 = c0 if c0 is not None else Fq2.zero()
            self.c1 = c1 if c1 is not None else Fq2.zero()
            self.c2 = c2 if c2 is not None else Fq2.zero()

        @classmethod
        def one(cls):
            return cls(Fq2.one(), Fq2.zero(), Fq2.zero())

        @classmethod
        def zero(cls):
            return cls()

        def __add__(self, o):
            return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

        def __sub__(self, o):
            return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

        def __neg__(self):
            return Fq6(-self.c0, -self.c1, -self.c2)

        def __mul__(self, o):
            if isinstance(o, (int, Fq2)):
                return Fq6(self.c0 * o, self.c1 * o, self.c2 * o)
            a0, a1, a2 = self.c0, self.c1, self.c2
            b0, b1, b2 = o.c0, o.c1, o.c2
            t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
            c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue() + t0
            c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
            c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
            return Fq6(c0, c1, c2)

        __rmul__ = __mul__

        def mul_by_v(self):
            """Multiply by v: (c0, c1, c2) -> (xi*c2, c0, c1)."""
            return Fq6(self.c2.mul_by_nonresidue(), self.c0, self.c1)

        def inverse(self):
            a, b, c = self.c0, self.c1, self.c2
            t0 = a * a - (b * c).mul_by_nonresidue()
            t1 = (c * c).mul_by_nonresidue() - a * b
            t2 = b * b - a * c
            denom = a * t0 + (b * t2 + c * t1).mul_by_nonresidue()
            denom_inv = denom.inverse()
            return Fq6(t0 * denom_inv, t1 * denom_inv, t2 * denom_inv)

        def __eq__(self, o):
            if isinstance(o, int):
                return self.c0 == o and not self.c1 and not self.c2
            return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

        def __bool__(self):
            return bool(self.c0) or bool(self.c1) or bool(self.c2)

        def __repr__(self):
            return f"Fq6({self.c0}, {self.c1}, {self.c2})"

    class Fq12:
        __slots__ = ("c0", "c1")

        def __init__(self, c0=None, c1=None):
            self.c0 = c0 if c0 is not None else Fq6.zero()
            self.c1 = c1 if c1 is not None else Fq6.zero()

        @classmethod
        def one(cls):
            return cls(Fq6.one(), Fq6.zero())

        @classmethod
        def zero(cls):
            return cls()

        @classmethod
        def from_int(cls, v: int):
            return cls(Fq6(Fq2(v, 0)), Fq6.zero())

        def __add__(self, o):
            o = _c12(o)
            return Fq12(self.c0 + o.c0, self.c1 + o.c1)

        __radd__ = __add__

        def __sub__(self, o):
            o = _c12(o)
            return Fq12(self.c0 - o.c0, self.c1 - o.c1)

        def __rsub__(self, o):
            return _c12(o) - self

        def __neg__(self):
            return Fq12(-self.c0, -self.c1)

        def __mul__(self, o):
            if isinstance(o, int):
                o = Fq12.from_int(o)
            a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
            t0 = a0 * b0
            t1 = a1 * b1
            # w^2 = v
            return Fq12(t0 + t1.mul_by_v(), (a0 + a1) * (b0 + b1) - t0 - t1)

        __rmul__ = __mul__

        def conjugate(self):
            """The p^6 Frobenius: a + bw -> a - bw."""
            return Fq12(self.c0, -self.c1)

        def inverse(self):
            # 1/(a + bw) = (a - bw)/(a^2 - v b^2)
            denom = self.c0 * self.c0 - (self.c1 * self.c1).mul_by_v()
            denom_inv = denom.inverse()
            return Fq12(self.c0 * denom_inv, -(self.c1 * denom_inv))

        def __truediv__(self, o):
            return self * _c12(o).inverse()

        def __pow__(self, e: int):
            result, base = Fq12.one(), self
            if e < 0:
                base, e = self.inverse(), -e
            while e:
                if e & 1:
                    result = result * base
                base = base * base
                e >>= 1
            return result

        def __eq__(self, o):
            o = _c12(o)
            return self.c0 == o.c0 and self.c1 == o.c1

        def __hash__(self):
            h = (self.c0.c0.c0, self.c0.c0.c1, self.c1.c0.c0)
            return hash((p, h))

        def __bool__(self):
            return bool(self.c0) or bool(self.c1)

        def __repr__(self):
            return f"Fq12({self.c0}, {self.c1})"

    def _c12(o):
        return Fq12.from_int(o) if isinstance(o, int) else o

    # -- Frobenius coefficients: v^p = FROB_V * v, w^p = FROB_W * w -------
    Fq12.FROB_V = XI ** ((p - 1) // 3)   # xi^((p-1)/3)
    Fq12.FROB_W = XI ** ((p - 1) // 6)   # xi^((p-1)/6)

    def frobenius_fq6(x: Fq6) -> Fq6:
        """(c0 + c1 v + c2 v^2)^p with v^p = FROB_V * v."""
        return Fq6(
            x.c0.conjugate(),
            x.c1.conjugate() * Fq12.FROB_V,
            x.c2.conjugate() * (Fq12.FROB_V * Fq12.FROB_V),
        )

    def frobenius(x: Fq12) -> Fq12:
        """x^p via coefficient-wise Frobenius (cheap; no big exponent)."""
        return Fq12(frobenius_fq6(x.c0), frobenius_fq6(x.c1) * Fq12.FROB_W)

    Fq12.frobenius = frobenius

    _TOWER_CACHE[key] = (Fq2, Fq6, Fq12)
    return _TOWER_CACHE[key]
