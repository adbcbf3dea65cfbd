"""Host-side dense univariate polynomials over a prime field.

Plays the role of Sage's ``PolynomialRing(Fq, 'X')`` in the reference
(``kzg.py:53``, ``marlin/encoder.py:22``,
``plonk/encoder.py:22``): exact coefficient arithmetic used by the protocol
layer for small/medium instances and as the oracle for the device NTT /
evaluation-form pipelines.

Coefficients are stored little-endian (``coeffs[i]`` multiplies ``X^i``) and
normalized (no trailing zeros); the zero polynomial has ``coeffs == []`` and
``degree() == -1``, matching Sage's conventions for ``.list()`` / ``.degree()``.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from .field import FieldElement


class Poly:
    __slots__ = ("field", "coeffs")

    def __init__(self, field: type[FieldElement], coeffs: Iterable = ()):
        self.field = field
        cs = [c if isinstance(c, FieldElement) else field(c) for c in coeffs]
        while cs and cs[-1].n == 0:
            cs.pop()
        self.coeffs = cs

    # -- constructors ------------------------------------------------------
    @classmethod
    def constant(cls, field, c) -> "Poly":
        return cls(field, [c])

    @classmethod
    def x(cls, field) -> "Poly":
        """The indeterminate X (Sage's ``R.gen()``, kzg.py:54)."""
        return cls(field, [0, 1])

    @classmethod
    def monomial(cls, field, degree: int, c=1) -> "Poly":
        return cls(field, [0] * degree + [c])

    @classmethod
    def vanishing(cls, field, n: int) -> "Poly":
        """X^n - 1, the vanishing polynomial of a size-n multiplicative
        subgroup (marlin/encoder.py:54-55, plonk/encoder.py:70)."""
        return cls(field, [-1] + [0] * (n - 1) + [1])

    @classmethod
    def lagrange(cls, field, points: Sequence[tuple]) -> "Poly":
        """Lagrange interpolation through ``points`` (Sage's
        ``R.lagrange_polynomial``, marlin/encoder.py:155)."""
        xs = [field(p[0]) for p in points]
        ys = [field(p[1]) for p in points]
        result = cls(field)
        for i, (xi, yi) in enumerate(zip(xs, ys)):
            basis = cls(field, [1])
            denom = field(1)
            for j, xj in enumerate(xs):
                if j == i:
                    continue
                basis = basis * cls(field, [-xj, 1])
                denom = denom * (xi - xj)
            result = result + basis * (yi / denom)
        return result

    # -- inspection --------------------------------------------------------
    def degree(self) -> int:
        return len(self.coeffs) - 1

    def list(self) -> list:
        """Coefficient list up to degree (Sage ``.list()``, kzg.py:110)."""
        return list(self.coeffs)

    def padded(self, n: int) -> list:
        """Coefficients padded with zeros to length n."""
        zero = self.field(0)
        return list(self.coeffs) + [zero] * (n - len(self.coeffs))

    def constant_coefficient(self):
        return self.coeffs[0] if self.coeffs else self.field(0)

    def is_zero(self) -> bool:
        return not self.coeffs

    def __bool__(self):
        return bool(self.coeffs)

    def __eq__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return self.coeffs == other.coeffs

    def __hash__(self):
        return hash((self.field.modulus, tuple(c.n for c in self.coeffs)))

    def __repr__(self):
        if not self.coeffs:
            return "0"
        terms = []
        for i, c in enumerate(self.coeffs):
            if c.n == 0:
                continue
            if i == 0:
                terms.append(str(c))
            elif i == 1:
                terms.append(f"{c}*X")
            else:
                terms.append(f"{c}*X^{i}")
        return " + ".join(reversed(terms))

    # -- coercion ----------------------------------------------------------
    def _coerce(self, other) -> "Poly":
        if isinstance(other, Poly):
            return other
        if isinstance(other, (int, FieldElement)):
            return Poly(self.field, [other])
        return NotImplemented

    # -- ring operations ---------------------------------------------------
    def __add__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        a, b = self.coeffs, other.coeffs
        if len(a) < len(b):
            a, b = b, a
        out = list(a)
        for i, c in enumerate(b):
            out[i] = out[i] + c
        return Poly(self.field, out)

    __radd__ = __add__

    def __neg__(self):
        return Poly(self.field, [-c for c in self.coeffs])

    def __sub__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return self + (-other)

    def __rsub__(self, other):
        return (-self) + other

    def __mul__(self, other):
        if isinstance(other, (int, FieldElement)):
            c = other if isinstance(other, FieldElement) else self.field(other)
            return Poly(self.field, [ci * c for ci in self.coeffs])
        if not isinstance(other, Poly):
            return NotImplemented
        a, b = self.coeffs, other.coeffs
        if not a or not b:
            return Poly(self.field)
        mod = self.field.modulus
        an = [c.n for c in a]
        bn = [c.n for c in b]
        out = [0] * (len(a) + len(b) - 1)
        for i, ai in enumerate(an):
            if ai == 0:
                continue
            for j, bj in enumerate(bn):
                out[i + j] += ai * bj
        return Poly(self.field, [v % mod for v in out])

    __rmul__ = __mul__

    def __pow__(self, e: int):
        result = Poly(self.field, [1])
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def divmod(self, divisor: "Poly") -> tuple["Poly", "Poly"]:
        """Euclidean division (Sage ``//`` and ``%``, e.g. kzg.py:154,
        marlin/prover.py:96,133-134, plonk usage throughout)."""
        divisor = self._coerce(divisor)
        if divisor.is_zero():
            raise ZeroDivisionError("polynomial division by zero")
        rem = list(self.coeffs)
        d = divisor.degree()
        lead_inv = divisor.coeffs[-1].inverse()
        if len(rem) - 1 < d:
            return Poly(self.field), Poly(self.field, rem)
        q = [self.field(0)] * (len(rem) - d)
        for k in range(len(rem) - 1, d - 1, -1):
            c = rem[k]
            if c.n == 0:
                continue
            factor = c * lead_inv
            q[k - d] = factor
            for j in range(d + 1):
                rem[k - d + j] = rem[k - d + j] - factor * divisor.coeffs[j]
        return Poly(self.field, q), Poly(self.field, rem)

    def __floordiv__(self, other):
        if isinstance(other, (int, FieldElement)):
            return self * (self.field(1) / self.field(other))
        return self.divmod(other)[0]

    def __mod__(self, other):
        return self.divmod(self._coerce(other))[1]

    def __truediv__(self, other):
        """Exact division; raises if the division leaves a remainder.

        The reference leans on Sage fraction-field coercion (e.g.
        plonk/prover.py:297-316); here exactness is asserted instead.
        """
        if isinstance(other, (int, FieldElement)):
            return self * (self.field(1) / self.field(other))
        q, r = self.divmod(other)
        if not r.is_zero():
            raise ValueError("inexact polynomial division")
        return q

    def exact_div(self, other) -> "Poly":
        return self.__truediv__(other)

    # -- evaluation / substitution ----------------------------------------
    def __call__(self, x):
        """Horner evaluation at a field element, or composition p(q(X))
        when called with a Poly (used for z(gX), plonk/prover.py:305)."""
        if isinstance(x, Poly):
            result = Poly(self.field)
            for c in reversed(self.coeffs):
                result = result * x + c
            return result
        x = x if isinstance(x, FieldElement) else self.field(x)
        acc = self.field(0)
        for c in reversed(self.coeffs):
            acc = acc * x + c
        return acc

    def scale_argument(self, c) -> "Poly":
        """p(c*X): coefficient i scaled by c^i — cheap form of the z(omega*X)
        shift (plonk/prover.py:305) without full composition."""
        c = c if isinstance(c, FieldElement) else self.field(c)
        out, power = [], self.field(1)
        for coeff in self.coeffs:
            out.append(coeff * power)
            power = power * c
        return Poly(self.field, out)

    def shift(self, k: int) -> "Poly":
        """Multiply by X^k (k >= 0) or exactly divide by X^k (k < 0)."""
        if k >= 0:
            return Poly(self.field, [0] * k + [c.n for c in self.coeffs])
        if any(c.n != 0 for c in self.coeffs[:-k]):
            raise ValueError("shift would truncate nonzero coefficients")
        return Poly(self.field, self.coeffs[-k:])

    def derivative(self) -> "Poly":
        """Formal derivative (used by u_H, marlin/encoder.py:83)."""
        return Poly(self.field, [c * i for i, c in enumerate(self.coeffs)][1:])
