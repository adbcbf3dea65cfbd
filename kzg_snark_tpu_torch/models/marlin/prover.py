"""Marlin prover (Appendix-E optimized AHP over R1CS).

Behavioral equivalent of ``marlin/prover.py``: same round
structure, transcript labels and challenge schedule (:54-221), same
commit/open orderings (:105,141,175,224-227), same blinding-polynomial
shapes (:79-102), and the same algebraic identities asserted in-line.

Idiomatic differences (host path):
  * ``u_H(alpha, X)`` built in closed form (Encoder.u_H_poly) instead of
    Sage fraction coercion.
  * ``t(X)`` accumulates exact quotients ``v_H // (X - row(kappa))`` rather
    than fraction-field division (reference :282-299); terms with zero
    ``val`` are skipped — they contribute nothing either way.
The device pipeline additionally computes t/f2/quotients in evaluation form
(see ``ops.ntt`` and the models' device paths).
"""

from __future__ import annotations

from ...rng import Rng, DEFAULT_RNG
from ...transcript import Transcript
from ...ops.host.fft import fft_ff, fft_interpolation
from ...ops.host.poly import Poly
from ..kzg import KZG
from .encoder import Encoder


class Prover:
    def __init__(self, curve_type: str = "bn254", backend: str = "host",
                 rng: Rng | None = None):
        self.backend = backend
        self.kzg = KZG(curve_type=curve_type, backend=backend, rng=rng)
        self.rng = self.kzg.rng

    # ------------------------------------------------------------------
    def prove(self, ipk, x, w, zero_knowledge_bound: int = 2):
        if self.backend == "cuda":
            # Full device pipeline (NTT/MSM/segment-sum on the GPU) — same
            # protocol, transcript, and RNG draw order; see
            # models/marlin/device.py.
            from .device import DeviceProver
            dp = DeviceProver(curve_type=self.kzg.curve_type, rng=self.rng)
            return dp.prove(ipk, x, w, zero_knowledge_bound)
        return self._prove_host(ipk, x, w, zero_knowledge_bound)

    def _prove_host(self, ipk, x, w, zero_knowledge_bound: int = 2):
        ck = ipk["ck"]
        A, B, C = ipk["A"], ipk["B"], ipk["C"]
        polynomials = ipk["polynomials"]
        H, K = ipk["subgroups"]["H"], ipk["subgroups"]["K"]
        n, m = ipk["subgroups"]["n"], ipk["subgroups"]["m"]
        g_K = ipk["subgroups"]["g_K"]
        v_H, v_K = ipk["vanishing_polys"]["v_H"], ipk["vanishing_polys"]["v_K"]
        Fq = self.kzg.Fq
        X = Poly.x(Fq)

        self.encoder = Encoder(Fq)
        self.encoder.update_state(A, B, C)

        transcript = Transcript("marlin-proof", Fq)
        transcript.append_message("public-inputs", list(x))

        # Phase 1: encode witness and linear combinations (reference :58-77).
        z = list(x) + list(w)
        x_size = len(x)

        v_H_x = Poly(Fq, [1])
        for h in H[:x_size]:
            v_H_x = v_H_x * Poly(Fq, [-h, 1])
        v_H_w = Poly(Fq, [1])
        for h in H[x_size:]:
            v_H_w = v_H_w * Poly(Fq, [-h, 1])

        encoded_witness = self.encoder.encode_witness(z, x_size)
        encoded_combinations = self.encoder.encode_linear_combinations(z)

        w_poly = encoded_witness["w_poly"]
        x_poly = encoded_witness["x_poly"]
        zA_poly = encoded_combinations["zA_poly"]
        zB_poly = encoded_combinations["zB_poly"]
        zC_poly = encoded_combinations["zC_poly"]

        # Zero-knowledge masking (reference :79-102).  RNG draw order is part
        # of the reproducibility contract: w, zA, zB, zC (degree < b each),
        # then s (degree < 2n+b-1).
        b = zero_knowledge_bound
        draw = lambda k: Poly(Fq, [self.rng.random_element(Fq) for _ in range(k)])
        w_random = draw(b)
        zA_random = draw(b)
        zB_random = draw(b)
        zC_random = draw(b)

        w_masked = w_poly + w_random * v_H_w
        zA_masked = zA_poly + zA_random * v_H
        zB_masked = zB_poly + zB_random * v_H
        zC_masked = zC_poly + zC_random * v_H
        z_masked = w_masked * v_H_x + x_poly

        # h_0: zA*zB - zC = h_0 * v_H (reference :96-97).
        h_0 = (zA_masked * zB_masked - zC_masked) / v_H  # exact (asserting)

        # s with sum over H forced to zero (reference :99-102).
        s_random = draw(2 * n + b - 1)
        s_sum = sum((s_random(h) for h in H), Fq(0))
        s = s_random - s_sum / Fq(len(H))

        # Round 1 (reference :105-119).
        first_round_polys = [w_masked, zA_masked, zB_masked, zC_masked, h_0, s]
        first_round_commitments = self.kzg.commit(ck, first_round_polys)
        transcript.append_message("round1-commitments", first_round_commitments)
        eta_A = transcript.get_challenge("eta_A")
        eta_B = transcript.get_challenge("eta_B")
        eta_C = transcript.get_challenge("eta_C")
        alpha = transcript.get_challenge("alpha")
        while alpha in H:
            alpha = transcript.get_challenge("alpha-retry")

        # t(X) (reference :122-124 -> :248-301).
        t = self._compute_t_polynomial(polynomials, eta_A, eta_B, eta_C,
                                       alpha, v_H, K)

        # First sumcheck (reference :127-138).
        r_alpha_X = self.encoder.u_H_poly(alpha)
        poly = (s + r_alpha_X * (zA_masked * eta_A + zB_masked * eta_B
                                 + zC_masked * eta_C) - t * z_masked)
        h_1, g_1 = poly.divmod(v_H)
        assert g_1.constant_coefficient() == 0, "Sum over H is not 0"
        g_1 = g_1 // X
        assert h_1 * v_H + X * g_1 == poly, "h_1 and g_1 are not well-defined"

        # Round 2 (reference :141-151).
        second_round_polys = [t, g_1, h_1]
        second_round_commitments = self.kzg.commit(ck, second_round_polys)
        transcript.append_message("round2-commitments", second_round_commitments)
        beta_1 = transcript.get_challenge("beta_1")
        while beta_1 in H:
            beta_1 = transcript.get_challenge("beta_1-retry")

        # Second sumcheck over K (reference :154-172).
        a, b_poly = self._compute_a_b_polynomials(
            polynomials, eta_A, eta_B, eta_C, beta_1, alpha, v_H)
        t_beta1 = t(beta_1)
        f_2 = self._compute_f2_polynomial(
            polynomials, eta_A, eta_B, eta_C, beta_1, alpha, v_H, m, g_K)
        assert f_2.constant_coefficient() == t_beta1 / Fq(m), "f_2 polynomial is incorrect"

        g_2 = f_2 // X
        h_2 = (a - b_poly * f_2) / v_K  # exact (asserting)
        assert h_2 * v_K == a - b_poly * (X * g_2 + t_beta1 / Fq(m)), \
            "h_2 and g_2 are not well-defined"

        # Round 3 (reference :175-181).
        third_round_polys = [g_2, h_2]
        third_round_commitments = self.kzg.commit(ck, third_round_polys)
        transcript.append_message("round3-commitments", third_round_commitments)
        beta_2 = transcript.get_challenge("beta_2")

        # Linearization polynomials f1, f2, f3 (reference :184-201).
        f_1 = zB_masked * zA_masked(beta_1) - zC_masked - h_0 * v_H(beta_1)

        z_lin = w_masked * v_H_x(beta_1) + x_poly(beta_1)
        r_alpha_beta1 = self.encoder.u_H(alpha, beta_1)
        f_2_lin = (s
                   + (zB_masked * eta_B + zC_masked * eta_C
                      + eta_A * zA_masked(beta_1)) * r_alpha_beta1
                   - z_lin * t_beta1 - h_1 * v_H(beta_1) - g_1 * beta_1)

        a_lin, b_lin = self._compute_a_b_linear_polynomials(
            polynomials, eta_A, eta_B, eta_C, beta_1, beta_2, alpha, v_H)
        f_3 = h_2 * v_K(beta_2) - a_lin + (g_2 * beta_2 + t_beta1 / Fq(m)) * b_lin

        assert f_1(beta_1) == 0, "f_1 polynomial is not well-defined"
        assert f_2_lin(beta_1) == 0, "f_2 polynomial is not well-defined"
        assert f_3(beta_2) == 0, "f_3 polynomial is not well-defined"

        # Evaluations (reference :204-221).
        polys_beta1 = [zA_masked, t]
        evals_beta1 = [p(beta_1) for p in polys_beta1]
        polys_beta2 = []
        for matrix in ["A", "B", "C"]:
            for poly_type in ["row", "col"]:
                polys_beta2.append(polynomials[f"{poly_type}_{matrix}"])
        evals_beta2 = [p(beta_2) for p in polys_beta2]

        transcript.append_message("evaluations-beta1", evals_beta1)
        transcript.append_message("evaluations-beta2", evals_beta2)
        xi_1 = transcript.get_challenge("xi_1")
        xi_2 = transcript.get_challenge("xi_2")

        # KZG openings (reference :224-227).
        polys_beta1 = [f_1, f_2_lin] + polys_beta1
        polys_beta2 = [f_3] + polys_beta2
        proof_beta1 = self.kzg.open(ck, polys_beta1, beta_1, xi_1)
        proof_beta2 = self.kzg.open(ck, polys_beta2, beta_2, xi_2)

        return {
            "commitments": {
                "first_round": first_round_commitments,
                "second_round": second_round_commitments,
                "third_round": third_round_commitments,
            },
            "evaluations": {
                "beta1": evals_beta1,
                "beta2": evals_beta2,
            },
            "kzg_proofs": {
                "beta1": proof_beta1,
                "beta2": proof_beta2,
            },
        }

    # ------------------------------------------------------------------
    def _compute_t_polynomial(self, polynomials, eta_A, eta_B, eta_C,
                              alpha, v_H: Poly, K) -> Poly:
        """t(X) = sum_M eta_M sum_{kappa in K}
        v_H(X) v_H(alpha) val_M(kappa) / ((X - row_M(kappa)) (alpha - col_M(kappa)))
        (reference :248-301).  Exact quotient form: each summand is
        scalar * (v_H // (X - row)); zero-val terms vanish identically."""
        Fq = self.kzg.Fq
        t_poly = Poly(Fq)
        v_H_alpha = v_H(alpha)
        quotient_cache: dict = {}
        for name, eta in (("A", eta_A), ("B", eta_B), ("C", eta_C)):
            row = polynomials[f"row_{name}"]
            col = polynomials[f"col_{name}"]
            val = polynomials[f"val_{name}"]
            for kappa in K:
                v = val(kappa)
                if v == 0:
                    continue
                r_k = row(kappa)
                c_k = col(kappa)
                if alpha == c_k:
                    continue  # reference skips zero denominators (:285)
                key = r_k.n
                q = quotient_cache.get(key)
                if q is None:
                    q = v_H / Poly(Fq, [-r_k, 1])
                    quotient_cache[key] = q
                t_poly = t_poly + q * (eta * v_H_alpha * v / (alpha - c_k))
        return t_poly

    # ------------------------------------------------------------------
    def _compute_a_b_polynomials(self, polynomials, eta_A, eta_B, eta_C,
                                 beta_1, alpha, v_H: Poly):
        """a(X), b(X) for the K-sumcheck (reference :303-353)."""
        Fq = self.kzg.Fq
        mats = [(eta_A, polynomials["row_A"], polynomials["col_A"], polynomials["val_A"]),
                (eta_B, polynomials["row_B"], polynomials["col_B"], polynomials["val_B"]),
                (eta_C, polynomials["row_C"], polynomials["col_C"], polynomials["val_C"])]
        a = Poly(Fq)
        b = Poly(Fq, [1])
        scale = v_H(beta_1) * v_H(alpha)
        for matrix_idx, (eta, row, col, val) in enumerate(mats):
            other_product = Poly(Fq, [1])
            for other_idx, (_, other_row, other_col, _) in enumerate(mats):
                if other_idx != matrix_idx:
                    other_product = other_product * (
                        (beta_1 - other_row) * (alpha - other_col))
            a = a + val * other_product * (eta * scale)
            b = b * ((beta_1 - row) * (alpha - col))
        return a, b

    def _compute_a_b_linear_polynomials(self, polynomials, eta_A, eta_B, eta_C,
                                        beta_1, beta_2, alpha, v_H: Poly):
        """Linearized a(X) (only val stays polynomial) and scalar b at beta_2
        (reference :355-402)."""
        Fq = self.kzg.Fq
        mats = [(eta_A, polynomials["row_A"], polynomials["col_A"], polynomials["val_A"]),
                (eta_B, polynomials["row_B"], polynomials["col_B"], polynomials["val_B"]),
                (eta_C, polynomials["row_C"], polynomials["col_C"], polynomials["val_C"])]
        a = Poly(Fq)
        b = Fq(1)
        scale = v_H(beta_1) * v_H(alpha)
        for matrix_idx, (eta, row, col, val) in enumerate(mats):
            other_product = Fq(1)
            for other_idx, (_, other_row, other_col, _) in enumerate(mats):
                if other_idx != matrix_idx:
                    other_product = other_product * (
                        (beta_1 - other_row(beta_2)) * (alpha - other_col(beta_2)))
            a = a + val * (eta * scale * other_product)
            b = b * ((beta_1 - row(beta_2)) * (alpha - col(beta_2)))
        return a, b

    # ------------------------------------------------------------------
    def _compute_f2_polynomial(self, polynomials, eta_A, eta_B, eta_C,
                               beta_1, alpha, v_H: Poly, m: int, g_K) -> Poly:
        """f2 by evaluation over K: FFT-evaluate the nine index polynomials,
        combine pointwise, interpolate back (reference :404-471)."""
        Fq = self.kzg.Fq
        v_H_beta1 = v_H(beta_1)
        v_H_alpha = v_H(alpha)
        evals = {}
        for name in ("A", "B", "C"):
            for kind in ("row", "col", "val"):
                p = polynomials[f"{kind}_{name}"]
                evals[f"{kind}_{name}"] = fft_ff(p.padded(m), g_K, Fq)

        f2_evals = []
        scale = v_H_beta1 * v_H_alpha
        for i in range(m):
            total = Fq(0)
            for name, eta in (("A", eta_A), ("B", eta_B), ("C", eta_C)):
                denom = ((beta_1 - evals[f"row_{name}"][i])
                         * (alpha - evals[f"col_{name}"][i]))
                if denom != 0:
                    total = total + eta * (scale * evals[f"val_{name}"][i] / denom)
            f2_evals.append(total)
        return fft_interpolation(f2_evals, g_K)
