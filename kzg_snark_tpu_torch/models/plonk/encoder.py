"""PLONK circuit encoder.

Behavioral equivalent of ``plonk/encoder.py``: domain and
coset construction (:37-97), selector encoding (:99-123), permutation
encoding into S_sigma polynomials + the flat sigma_star table (:125-168),
witness encoding (:170-208), and the Lagrange-basis / public-input
polynomials (:210-257).

The coset multipliers k1, k2 are rejection-sampled exactly as the reference
does (:72-97) but through the injectable Rng so indexing is reproducible.
"""

from __future__ import annotations

from ...rng import Rng, DEFAULT_RNG
from ...ops.host.fft import fft_interpolation
from ...ops.host.field import FieldElement, scalar_field, prime_field
from ...ops.host.poly import Poly


class Encoder:
    def __init__(self, q: int | type[FieldElement], rng: Rng | None = None):
        if isinstance(q, int):
            from ... import constants as C
            if q == C.BN254_R:
                self.Fq = scalar_field("bn254")
            elif q == C.BLS12_381_R:
                self.Fq = scalar_field("bls12_381")
            else:
                self.Fq = prime_field(q, 0, 0, "F")
        else:
            self.Fq = q
        self.rng = rng if rng is not None else DEFAULT_RNG
        self.X = Poly.x(self.Fq)

    @staticmethod
    def find_subgroup_size(n: int) -> int:
        return 2 ** ((n - 1).bit_length())

    # ------------------------------------------------------------------
    def update_state(self, qM, qL, qR, qO, qC, perm) -> None:
        """Subgroup H, cosets k1*H / k2*H, vanishing polynomial
        (reference plonk/encoder.py:37-70)."""
        self.n = self.find_subgroup_size(len(qM))
        self.g = self.Fq.nth_root_of_unity(self.n)
        self.qM, self.qL, self.qR, self.qO, self.qC = qM, qL, qR, qO, qC
        self.perm = perm
        self.H = [self.g ** i for i in range(self.n)]
        self._find_coset_multipliers()
        self.k1H = [self.k1 * h for h in self.H]
        self.k2H = [self.k2 * h for h in self.H]
        self.v_H = Poly.vanishing(self.Fq, self.n)

    def _find_coset_multipliers(self) -> None:
        """Rejection-sample k1, k2 with k1^n != 1, k2^n != 1, (k1/k2)^n != 1
        (reference plonk/encoder.py:72-97) — through the seedable Rng."""
        n = self.n
        while True:
            k1 = self.rng.random_element(self.Fq)
            k2 = self.rng.random_element(self.Fq)
            if (k1 != 0 and k2 != 0 and k1 ** n != 1 and k2 ** n != 1
                    and (k1 / k2) ** n != 1):
                self.k1 = k1
                self.k2 = k2
                return

    # ------------------------------------------------------------------
    def encode_selectors(self) -> dict:
        """Interpolate the five selector polynomials over H
        (reference plonk/encoder.py:99-123)."""
        if not hasattr(self, "H"):
            raise ValueError("Call update_state before encoding selectors")
        F = self.Fq
        pad = lambda vals: [F(int(v)) for v in vals] + [F(0)] * (self.n - len(vals))
        return {
            "qM": fft_interpolation(pad(self.qM), self.g),
            "qL": fft_interpolation(pad(self.qL), self.g),
            "qR": fft_interpolation(pad(self.qR), self.g),
            "qO": fft_interpolation(pad(self.qO), self.g),
            "qC": fft_interpolation(pad(self.qC), self.g),
        }

    # ------------------------------------------------------------------
    def index_to_element(self, i: int):
        """Map a wire index in [0, 3n) into H u k1H u k2H
        (reference plonk/encoder.py:140-149)."""
        n = self.n
        if 0 <= i < n:
            return self.H[i]
        if n <= i < 2 * n:
            return self.k1H[i - n]
        if 2 * n <= i < 3 * n:
            return self.k2H[i - 2 * n]
        raise ValueError(f"Index {i} out of range [0, {3 * n - 1}]")

    def encode_permutation(self) -> dict:
        """S_sigma1/2/3 polynomials plus the flat sigma_star table
        (reference plonk/encoder.py:125-168)."""
        if not hasattr(self, "k1"):
            raise ValueError("Call update_state before encoding permutation")
        n = self.n
        S_sigma1_values = [self.index_to_element(self.perm[i]) for i in range(n)]
        S_sigma2_values = [self.index_to_element(self.perm[i + n]) for i in range(n)]
        S_sigma3_values = [self.index_to_element(self.perm[i + 2 * n]) for i in range(n)]
        return {
            "S_sigma1": fft_interpolation(S_sigma1_values, self.g),
            "S_sigma2": fft_interpolation(S_sigma2_values, self.g),
            "S_sigma3": fft_interpolation(S_sigma3_values, self.g),
            "sigma_star": S_sigma1_values + S_sigma2_values + S_sigma3_values,
        }

    # ------------------------------------------------------------------
    def encode_witness(self, w, x_size: int = 0) -> dict:
        """Wire polynomials a/b/c plus public-input polynomial
        (reference plonk/encoder.py:170-208; the prover inlines this with
        blinding, plonk/prover.py:83-85)."""
        if not hasattr(self, "H"):
            raise ValueError("Call update_state before encoding witness")
        n = self.n
        F = self.Fq
        w = [F(int(v)) for v in w]
        a_values, b_values, c_values = w[:n], w[n:2 * n], w[2 * n:3 * n]
        x = w[:x_size] if x_size > 0 else []
        PI = self.compute_public_input_poly(x) if x_size > 0 else Poly(F)
        return {
            "a": fft_interpolation(a_values, self.g),
            "b": fft_interpolation(b_values, self.g),
            "c": fft_interpolation(c_values, self.g),
            "x": x,
            "PI": PI,
        }

    # ------------------------------------------------------------------
    def compute_lagrange_basis(self, i: int) -> Poly:
        """L_i(X) = g^i (X^n - 1) / (n (X - g^i))
        (reference plonk/encoder.py:210-235)."""
        if not hasattr(self, "H"):
            raise ValueError("Call update_state before computing Lagrange basis")
        numerator = self.v_H * (self.g ** i)
        denominator = Poly(self.Fq, [-(self.g ** i), 1]) * self.Fq(self.n)
        return numerator / denominator

    def compute_public_input_poly(self, x) -> Poly:
        """PI(X) = -sum_i x_i L_i(X) (reference plonk/encoder.py:237-257)."""
        if not hasattr(self, "H"):
            raise ValueError("Call update_state before computing public input poly")
        PI = Poly(self.Fq)
        for i, x_i in enumerate(x):
            PI = PI - self.compute_lagrange_basis(i) * self.Fq(int(x_i))
        return PI
