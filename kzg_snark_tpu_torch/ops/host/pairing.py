"""Host-side optimal-ate pairing for BN254 and BLS12-381.

Plays the role of py_ecc's ``pairing`` in the reference
(``kzg.py:208-209`` single check, ``:285-287`` batch check).
The verifier is O(1) pairings and stays on host (CPU) by design — see
SURVEY.md §3.5.  Pairing outputs are never hashed into the transcript, so any
mathematically correct implementation is interchangeable with py_ecc's.

Call convention matches the reference's py_ecc usage: ``pairing(Q, P)`` with
Q in G2 (Fq2 coordinates) and P in G1, both as projective triples.

Algorithm: untwist Q to E(Fq12), affine Miller loop with explicit line
evaluations, final exponentiation by the full exponent (p^12 - 1)/r.  A
Frobenius-based fast final exponentiation is a later optimization; the naive
exponent is the ground truth either way.
"""

from __future__ import annotations

from ... import constants as C
from .tower import tower_fields
from . import curve as pc


class PairingContext:
    """Per-curve pairing machinery (constructed once, cached)."""

    _CACHE: dict = {}

    def __new__(cls, curve_type: str = "bn254"):
        if curve_type in cls._CACHE:
            return cls._CACHE[curve_type]
        self = super().__new__(cls)
        self._init(curve_type)
        cls._CACHE[curve_type] = self
        return self

    def _init(self, curve_type: str):
        self.curve_type = curve_type
        if curve_type == "bn254":
            self.p, self.r = C.BN254_P, C.BN254_R
            self.xi = C.BN254_XI
            self.twist_type = "D"  # E': y^2 = x^3 + b/xi
            self.loop_count = C.BN254_ATE_LOOP
            self.loop_negative = False
            self.is_bn = True
        elif curve_type == "bls12_381":
            self.p, self.r = C.BLS12_381_P, C.BLS12_381_R
            self.xi = C.BLS12_381_XI
            self.twist_type = "M"  # E': y^2 = x^3 + b*xi
            self.loop_count = -C.BLS12_381_X  # |x|, x negative
            self.loop_negative = True
            self.is_bn = False
        else:
            raise ValueError(f"Unsupported curve type: {curve_type}")
        self.Fq2, self.Fq6, self.Fq12 = tower_fields(self.p, self.xi)
        self.final_exp_power = (self.p ** 12 - 1) // self.r

    # -- embeddings --------------------------------------------------------
    def _embed_fq(self, x: int):
        return self.Fq12.from_int(x)

    def _untwist(self, q):
        """Map an affine E'(Fq2) point to affine E(Fq12).

        D-type (BN254):  (x, y) -> (x * w^2, y * w^3)
        M-type (BLS12):  (x, y) -> (x / w^2, y / w^3)
        with w^2 = v, w^3 = v*w in the tower.
        """
        Fq2, Fq6, Fq12 = self.Fq2, self.Fq6, self.Fq12
        x, y = q
        xw2 = Fq12(Fq6(Fq2.zero(), x, Fq2.zero()), Fq6.zero())       # x * v
        yw3 = Fq12(Fq6.zero(), Fq6(Fq2.zero(), y, Fq2.zero()))       # y * v * w
        if self.twist_type == "D":
            return (xw2, yw3)
        w2_inv = Fq12(Fq6(Fq2.zero(), Fq2.one(), Fq2.zero()), Fq6.zero()).inverse()
        w3_inv = Fq12(Fq6.zero(), Fq6(Fq2.zero(), Fq2.one(), Fq2.zero())).inverse()
        x12 = Fq12(Fq6(x), Fq6.zero())
        y12 = Fq12(Fq6(y), Fq6.zero())
        return (x12 * w2_inv, y12 * w3_inv)

    # -- affine line functions in E(Fq12) ---------------------------------
    @staticmethod
    def _line(p1, p2, t):
        """Evaluate the line through affine points p1, p2 at affine t.

        Vertical line when p1 == -p2; tangent when p1 == p2.
        """
        x1, y1 = p1
        x2, y2 = p2
        xt, yt = t
        if x1 != x2:
            slope = (y2 - y1) / (x2 - x1)
            return slope * (xt - x1) - (yt - y1)
        if y1 == y2:
            slope = (x1 * x1 * 3) / (y1 * 2)
            return slope * (xt - x1) - (yt - y1)
        return xt - x1

    @staticmethod
    def _affine_add(p1, p2):
        x1, y1 = p1
        x2, y2 = p2
        if x1 != x2:
            slope = (y2 - y1) / (x2 - x1)
        elif y1 == y2:
            slope = (x1 * x1 * 3) / (y1 * 2)
        else:
            return None  # point at infinity (never hit in ate loop for r-torsion inputs)
        x3 = slope * slope - x1 - x2
        y3 = slope * (x1 - x3) - y1
        return (x3, y3)

    # -- the pairing -------------------------------------------------------
    def miller_loop(self, q_aff, p_aff):
        """f_{loop,Q}(P) with the curve-specific tail; q_aff/p_aff affine in
        E(Fq12)."""
        Fq12 = self.Fq12
        f = Fq12.one()
        t = q_aff
        bits = bin(self.loop_count)[2:]
        for bit in bits[1:]:
            f = f * f * self._line(t, t, p_aff)
            t = self._affine_add(t, t)
            if bit == "1":
                f = f * self._line(t, q_aff, p_aff)
                t = self._affine_add(t, q_aff)
        if self.is_bn:
            # Optimal-ate correction: two extra lines through pi(Q), pi^2(Q).
            frob = Fq12.frobenius
            q1 = (frob(q_aff[0]), frob(q_aff[1]))
            nq2 = (frob(q1[0]), -frob(q1[1]))
            f = f * self._line(t, q1, p_aff)
            t = self._affine_add(t, q1)
            f = f * self._line(t, nq2, p_aff)
        elif self.loop_negative:
            f = f.inverse()
        return f

    def pairing(self, q_proj, p_proj):
        """e(P, Q) for projective Q in G2(Fq2) and P in G1(Fq).

        Argument order matches py_ecc: ``pairing(G2_point, G1_point)``
        (reference kzg.py:208).
        """
        if pc.is_identity(q_proj) or pc.is_identity(p_proj):
            return self.Fq12.one()
        q_aff2 = pc.normalize(q_proj)         # affine over Fq2
        p_affq = pc.normalize(p_proj)         # affine over Fq
        q12 = self._untwist(q_aff2)
        p12 = (self._embed_fq(int(p_affq[0])), self._embed_fq(int(p_affq[1])))
        f = self.miller_loop(q12, p12)
        return self.final_exponentiation(f)

    def final_exponentiation(self, f):
        """f^((p^12-1)/r).

        Easy part via Frobenius/conjugation; hard part (p^4-p^2+1)/r via
        a 4-base Frobenius multi-exponentiation:
        write the hard exponent h in base p as h = c0 + c1 p + c2 p^2 +
        c3 p^3 (exact, h < p^4) — then f^h = f^c0 * pi(f)^c1 * pi^2(f)^c2
        * pi^3(f)^c3, since pi(f) = f^p identically in Fq12.  The four
        powers run as one Shamir simultaneous square-and-multiply with a
        16-entry subset-product table: ~log2(p) squarings + <= log2(p)
        muls, vs ~1.5*log2(h) = 6x log2(p) ops for the naive single
        exponent.  Exactness is pinned against the naive exponent in
        tests/test_curve_pairing.py.
        """
        # Easy part: f^(p^6-1) then ^(p^2+1).
        f = f.conjugate() * f.inverse()            # f^(p^6 - 1)
        f = f.frobenius().frobenius() * f          # ^(p^2 + 1)
        return self._hard_part(f)

    def _hard_part(self, f):
        """f^((p^4-p^2+1)/r) by base-p multi-exponentiation."""
        Fq12 = self.Fq12
        p = self.p
        if not hasattr(self, "_hard_digits"):
            h = (p ** 4 - p ** 2 + 1) // self.r
            digits = []
            for _ in range(4):
                digits.append(h % p)
                h //= p
            assert h == 0
            self._hard_digits = digits
        digits = self._hard_digits
        # Frobenius images: bases[i] = pi^i(f) = f^(p^i).
        bases = [f]
        for _ in range(3):
            bases.append(bases[-1].frobenius())
        # Subset-product table T[mask] = prod of selected bases.
        table = [Fq12.one()] * 16
        for mask in range(1, 16):
            low = mask & (-mask)
            table[mask] = table[mask ^ low] * bases[low.bit_length() - 1]
        nbits = max(d.bit_length() for d in digits)
        acc = Fq12.one()
        for bit in range(nbits - 1, -1, -1):
            acc = acc * acc
            mask = 0
            for i in range(4):
                if (digits[i] >> bit) & 1:
                    mask |= 1 << i
            if mask:
                acc = acc * table[mask]
        return acc


def pairing(q_proj, p_proj, curve_type: str = "bn254"):
    return PairingContext(curve_type).pairing(q_proj, p_proj)
