"""Marlin verifier.

Behavioral equivalent of ``marlin/verifier.py``: transcript
replay (:66-94), homomorphic reconstruction of the three linearization
commitments f1/f2/f3 (:104-141), and the final randomized two-instance
``batch_check`` (:143-163).  Stays on host: O(1) scalar muls + 2 pairings
(SURVEY.md §3.5).
"""

from __future__ import annotations

from ...rng import Rng
from ...transcript import Transcript
from ...ops.host.poly import Poly
from ..kzg import KZG


class Verifier:
    def __init__(self, curve_type: str = "bn254", backend: str = "host",
                 rng: Rng | None = None):
        self.kzg = KZG(curve_type=curve_type, backend=backend, rng=rng)

    def verify(self, ivk, x, proof) -> bool:
        kzg = self.kzg
        Fq = kzg.Fq
        rk = ivk["rk"]
        index_commitments = ivk["commitments"]
        n, m = ivk["subgroups"]["n"], ivk["subgroups"]["m"]
        g_H = ivk["subgroups"]["g_H"]
        v_H, v_K = ivk["vanishing_polys"]["v_H"], ivk["vanishing_polys"]["v_K"]

        first_round_commitments = proof["commitments"]["first_round"]
        second_round_commitments = proof["commitments"]["second_round"]
        third_round_commitments = proof["commitments"]["third_round"]
        evals_beta1 = proof["evaluations"]["beta1"]
        evals_beta2 = proof["evaluations"]["beta2"]
        kzg_proof_beta1 = proof["kzg_proofs"]["beta1"]
        kzg_proof_beta2 = proof["kzg_proofs"]["beta2"]

        # Transcript replay (reference :66-94).  NOTE the reference does NOT
        # re-run the alpha/beta_1 retry loops here; it assumes the main draw
        # landed outside H (overwhelmingly likely) — mirrored faithfully.
        transcript = Transcript("marlin-proof", Fq)
        transcript.append_message("public-inputs", list(x))
        transcript.append_message("round1-commitments", first_round_commitments)
        eta_A = transcript.get_challenge("eta_A")
        eta_B = transcript.get_challenge("eta_B")
        eta_C = transcript.get_challenge("eta_C")
        alpha = transcript.get_challenge("alpha")
        transcript.append_message("round2-commitments", second_round_commitments)
        beta_1 = transcript.get_challenge("beta_1")
        transcript.append_message("round3-commitments", third_round_commitments)
        beta_2 = transcript.get_challenge("beta_2")
        transcript.append_message("evaluations-beta1", evals_beta1)
        transcript.append_message("evaluations-beta2", evals_beta2)
        xi_1 = transcript.get_challenge("xi_1")
        xi_2 = transcript.get_challenge("xi_2")

        [zA_beta1, t_beta1] = evals_beta1
        [w_comm, zA_comm, zB_comm, zC_comm, h0_comm, s_comm] = first_round_commitments
        [t_comm, g1_comm, h1_comm] = second_round_commitments
        [g2_comm, h2_comm] = third_round_commitments

        # f1 commitment (reference :107-109).
        f1_comm = kzg.multiply(zB_comm, int(Fq(int(zA_beta1))))
        f1_comm = kzg.add(f1_comm, kzg.neg(zC_comm))
        f1_comm = kzg.add(f1_comm, kzg.multiply(h0_comm, int(-v_H(beta_1))))

        # f2 commitment (reference :111-131).
        H_x = [g_H ** i for i in range(len(x))]
        v_H_x_beta1 = Fq(1)
        for h in H_x:
            v_H_x_beta1 = v_H_x_beta1 * (beta_1 - h)
        x_points = [(H_x[i], Fq(int(x[i]))) for i in range(len(x))]
        x_poly = Poly.lagrange(Fq, x_points)
        x_beta1 = x_poly(beta_1)

        z_comm = kzg.multiply(w_comm, int(v_H_x_beta1))
        z_comm = kzg.add(z_comm, kzg.multiply(kzg.G1, int(x_beta1)))

        r_alpha_beta1 = (alpha ** n - beta_1 ** n) / (alpha - beta_1)

        t_beta1_f = Fq(int(t_beta1))
        f2_comm = s_comm
        temp = kzg.multiply(kzg.G1, int(eta_A * Fq(int(zA_beta1))))
        temp = kzg.add(temp, kzg.multiply(zB_comm, int(eta_B)))
        temp = kzg.add(temp, kzg.multiply(zC_comm, int(eta_C)))
        temp = kzg.multiply(temp, int(r_alpha_beta1))
        f2_comm = kzg.add(f2_comm, temp)
        f2_comm = kzg.add(f2_comm, kzg.multiply(z_comm, int(-t_beta1_f)))
        f2_comm = kzg.add(f2_comm, kzg.multiply(h1_comm, int(-v_H(beta_1))))
        f2_comm = kzg.add(f2_comm, kzg.multiply(g1_comm, int(-beta_1)))

        # f3 commitment (reference :133-141).
        a_comm, b_lin = self._compute_a_b_linear(
            index_commitments, evals_beta2, beta_1, alpha,
            eta_A, eta_B, eta_C, v_H)
        f3_comm = kzg.multiply(h2_comm, int(v_K(beta_2)))
        f3_comm = kzg.add(f3_comm, kzg.neg(a_comm))
        temp = kzg.multiply(g2_comm, int(beta_2))
        temp = kzg.add(temp, kzg.multiply(kzg.G1, int(t_beta1_f / Fq(m))))
        temp = kzg.multiply(temp, int(b_lin))
        f3_comm = kzg.add(f3_comm, temp)

        # Batch verification (reference :143-163); r=None -> randomized.
        beta1_commitments = [f1_comm, f2_comm, zA_comm, t_comm]
        beta2_commitments = [f3_comm]
        for matrix in ["A", "B", "C"]:
            for poly_type in ["row", "col"]:
                beta2_commitments.append(index_commitments[f"{poly_type}_{matrix}"])

        beta1_evaluations = [0] * 2 + list(evals_beta1)
        beta2_evaluations = [0] + list(evals_beta2)

        return kzg.batch_check(
            rk,
            [beta1_commitments, beta2_commitments],
            [beta_1, beta_2],
            [beta1_evaluations, beta2_evaluations],
            [kzg_proof_beta1, kzg_proof_beta2],
            [xi_1, xi_2],
        )

    # ------------------------------------------------------------------
    def _compute_a_b_linear(self, index_commitments, evals_beta2, beta_1,
                            alpha, eta_A, eta_B, eta_C, v_H: Poly):
        """Commitment-level counterpart of the prover's linearized a/b
        (reference :165-215)."""
        kzg = self.kzg
        Fq = kzg.Fq
        [row_A_b2, col_A_b2, row_B_b2, col_B_b2, row_C_b2, col_C_b2] = [
            Fq(int(e)) for e in evals_beta2]
        mats = [
            (eta_A, row_A_b2, col_A_b2, index_commitments["val_A"]),
            (eta_B, row_B_b2, col_B_b2, index_commitments["val_B"]),
            (eta_C, row_C_b2, col_C_b2, index_commitments["val_C"]),
        ]
        a = kzg.multiply(kzg.G1, 0)
        b = Fq(1)
        scale = v_H(beta_1) * v_H(alpha)
        for matrix_idx, (eta, row, col, val_comm) in enumerate(mats):
            other_product = Fq(1)
            for other_idx, (_, other_row, other_col, _) in enumerate(mats):
                if other_idx != matrix_idx:
                    other_product = other_product * (
                        (beta_1 - other_row) * (alpha - other_col))
            a = kzg.add(a, kzg.multiply(val_comm, int(eta * scale * other_product)))
            b = b * ((beta_1 - row) * (alpha - col))
        return a, b
