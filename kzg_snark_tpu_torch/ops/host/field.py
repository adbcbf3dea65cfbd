"""Host-side (exact, arbitrary-precision) prime field elements.

Plays the role SageMath's ``GF(curve_order)`` plays in the reference
(``kzg.py:52``): an exact scalar-field element type used by
the protocol layer, the transcript, and as the oracle for the device limb
kernels.

Transcript compatibility note: the reference hashes field elements via
``str(element)`` (``transcript.py:80-85``), where a Sage GF
element prints as its canonical decimal integer.  ``FieldElement.__str__``
therefore returns the decimal representation of the canonical representative
in ``[0, modulus)``.
"""

from __future__ import annotations


class FieldElement:
    """An element of GF(modulus); subclassed per-field via :func:`prime_field`."""

    __slots__ = ("n",)

    # Set by prime_field():
    modulus: int = 0
    generator: int = 0  # generator of the multiplicative group
    two_adicity: int = 0

    def __init__(self, value):
        if isinstance(value, FieldElement):
            value = value.n
        self.n = value % self.modulus

    # -- arithmetic --------------------------------------------------------
    def _coerce(self, other):
        if isinstance(other, FieldElement):
            return other.n
        if isinstance(other, int):
            return other % self.modulus
        return NotImplemented

    def __add__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return type(self)(self.n + o)

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return type(self)(self.n - o)

    def __rsub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return type(self)(o - self.n)

    def __mul__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return type(self)(self.n * o)

    __rmul__ = __mul__

    def __truediv__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return type(self)(self.n * pow(o, -1, self.modulus))

    def __rtruediv__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return type(self)(o * pow(self.n, -1, self.modulus))

    def __pow__(self, exponent: int):
        if exponent < 0:
            return type(self)(pow(pow(self.n, -1, self.modulus), -exponent, self.modulus))
        return type(self)(pow(self.n, exponent, self.modulus))

    def __neg__(self):
        return type(self)(-self.n)

    def inverse(self):
        return type(self)(pow(self.n, -1, self.modulus))

    # -- comparisons / hashing --------------------------------------------
    def __eq__(self, other):
        if isinstance(other, FieldElement):
            return self.n == other.n and self.modulus == other.modulus
        if isinstance(other, int):
            return self.n == other % self.modulus
        return NotImplemented

    def __ne__(self, other):
        result = self.__eq__(other)
        return NotImplemented if result is NotImplemented else not result

    def __hash__(self):
        return hash((self.modulus, self.n))

    def __bool__(self):
        return self.n != 0

    def __int__(self):
        return self.n

    __index__ = __int__

    # -- printing (transcript-critical, see module docstring) -------------
    def __str__(self):
        return str(self.n)

    def __repr__(self):
        return str(self.n)

    # -- roots of unity ----------------------------------------------------
    @classmethod
    def nth_root_of_unity(cls, n: int) -> "FieldElement":
        """Deterministic primitive n-th root of unity: generator^((q-1)/n).

        Plays the role of Sage's ``Fq(1).nth_root(n)``
        (``marlin/encoder.py:48-49``,
        ``plonk/encoder.py:49``).  Sage's choice of root is
        implementation-defined; this framework pins the standard choice
        g^((q-1)/n) with g the fixed field generator so that domains are
        reproducible.  Since g generates the full multiplicative group,
        g^((q-1)/n) has order exactly n whenever n | q-1.
        """
        q1 = cls.modulus - 1
        if q1 % n != 0:
            raise ValueError(f"{n} does not divide field order - 1")
        root = cls(cls.generator) ** (q1 // n)
        assert root ** n == 1
        return root

    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)


_FIELD_CACHE: dict[tuple[int, int], type[FieldElement]] = {}


def prime_field(modulus: int, generator: int = 0, two_adicity: int = 0,
                name: str = "F") -> type[FieldElement]:
    """Create (or fetch the cached) field-element class for ``modulus``."""
    key = (modulus, generator)
    cls = _FIELD_CACHE.get(key)
    if cls is None:
        cls = type(name, (FieldElement,), {
            "__slots__": (),
            "modulus": modulus,
            "generator": generator,
            "two_adicity": two_adicity,
        })
        _FIELD_CACHE[key] = cls
    return cls


def scalar_field(curve_type: str = "bn254") -> type[FieldElement]:
    """The scalar field GF(r) for the named curve (reference: kzg.py:52)."""
    from ... import constants as C

    if curve_type == "bn254":
        return prime_field(C.BN254_R, C.BN254_FR_GEN, C.BN254_FR_TWO_ADICITY, "FrBN254")
    if curve_type == "bls12_381":
        return prime_field(C.BLS12_381_R, C.BLS12_381_FR_GEN,
                           C.BLS12_381_FR_TWO_ADICITY, "FrBLS12381")
    raise ValueError(f"Unsupported curve type: {curve_type}")


def base_field(curve_type: str = "bn254") -> type[FieldElement]:
    """The base field GF(p) hosting curve point coordinates."""
    from ... import constants as C

    if curve_type == "bn254":
        return prime_field(C.BN254_P, 3, 1, "FqBN254")
    if curve_type == "bls12_381":
        return prime_field(C.BLS12_381_P, 2, 1, "FqBLS12381")
    raise ValueError(f"Unsupported curve type: {curve_type}")
