"""PLONK verifier.

Behavioral equivalent of ``plonk/verifier.py``: PI
recomputation via a throwaway encoder (:79-86), transcript replay including
the verifier-only batch challenge u (:88-121), homomorphic reconstruction of
the linearization commitment r_comm (:132-178), and the final two-instance
``batch_check`` with r = u (:180-213).
"""

from __future__ import annotations

from ...rng import Rng
from ...transcript import Transcript
from ..kzg import KZG
from .encoder import Encoder


class Verifier:
    def __init__(self, curve_type: str = "bn254", backend: str = "host",
                 rng: Rng | None = None):
        self.kzg = KZG(curve_type=curve_type, backend=backend, rng=rng)

    def verify(self, ivk, x, proof) -> bool:
        kzg = self.kzg
        Fq = kzg.Fq
        rk = ivk["rk"]
        commitments = ivk["commitments"]
        n = ivk["subgroups"]["n"]
        g = ivk["subgroups"]["g"]
        k1 = ivk["subgroups"]["k1"]
        k2 = ivk["subgroups"]["k2"]

        wire_commitments = [proof["commitments"]["a"],
                            proof["commitments"]["b"],
                            proof["commitments"]["c"]]
        z_comm = proof["commitments"]["z"]
        quotient_commitments = [proof["commitments"]["t_lo"],
                                proof["commitments"]["t_mid"],
                                proof["commitments"]["t_hi"]]
        W_z = proof["kzg_proofs"]["W_z"]
        W_zw = proof["kzg_proofs"]["W_zw"]

        a_zeta = Fq(int(proof["evaluations"]["a"]))
        b_zeta = Fq(int(proof["evaluations"]["b"]))
        c_zeta = Fq(int(proof["evaluations"]["c"]))
        s_sigma1_zeta = Fq(int(proof["evaluations"]["s_sigma1"]))
        s_sigma2_zeta = Fq(int(proof["evaluations"]["s_sigma2"]))
        z_omega_zeta = Fq(int(proof["evaluations"]["z_omega"]))

        qM_comm, qL_comm, qR_comm = commitments["qM"], commitments["qL"], commitments["qR"]
        qO_comm, qC_comm = commitments["qO"], commitments["qC"]
        s_sigma1_comm = commitments["S_sigma1"]
        s_sigma2_comm = commitments["S_sigma2"]
        s_sigma3_comm = commitments["S_sigma3"]

        # PI via throwaway encoder (reference :79-86).
        encoder = Encoder(Fq)
        empty_perm = [0] * (3 * n)
        empty_selectors = [Fq(0)] * n
        encoder.update_state(empty_selectors, empty_selectors, empty_selectors,
                             empty_selectors, empty_selectors, empty_perm)
        PI = encoder.compute_public_input_poly([Fq(int(v)) for v in x])

        # Transcript replay (reference :88-121).
        transcript = Transcript("plonk-proof", Fq)
        transcript.append_message("public-inputs", list(x))
        transcript.append_message("round1-commitments", wire_commitments)
        beta = transcript.get_challenge("beta")
        gamma = transcript.get_challenge("gamma")
        transcript.append_message("round2-commitment", z_comm)
        alpha = transcript.get_challenge("alpha")
        transcript.append_message("round3-commitments", quotient_commitments)
        zeta = transcript.get_challenge("zeta")
        evaluations = [a_zeta, b_zeta, c_zeta, s_sigma1_zeta, s_sigma2_zeta,
                       z_omega_zeta]
        transcript.append_message("round4-evaluations", evaluations)
        v = transcript.get_challenge("v")
        u = transcript.get_challenge("u")  # verifier-only batch randomizer

        # Scalars (reference :123-130).
        ZH_zeta = zeta ** n - 1
        L1_zeta = ZH_zeta / (Fq(n) * (zeta - 1))
        PI_zeta = PI(zeta)

        # r_comm: gate term (reference :132-139).
        r_comm = kzg.multiply(qM_comm, int(a_zeta * b_zeta))
        r_comm = kzg.add(r_comm, kzg.multiply(qL_comm, int(a_zeta)))
        r_comm = kzg.add(r_comm, kzg.multiply(qR_comm, int(b_zeta)))
        r_comm = kzg.add(r_comm, kzg.multiply(qO_comm, int(c_zeta)))
        r_comm = kzg.add(r_comm, kzg.multiply(kzg.G1, int(PI_zeta)))
        r_comm = kzg.add(r_comm, qC_comm)

        # Permutation terms (reference :141-166).
        factor_1 = ((a_zeta + beta * zeta + gamma)
                    * (b_zeta + beta * k1 * zeta + gamma)
                    * (c_zeta + beta * k2 * zeta + gamma))
        term_1 = kzg.multiply(z_comm, int(factor_1))

        c_poly_term = kzg.multiply(s_sigma3_comm, int(beta))
        c_poly_term = kzg.add(c_poly_term,
                              kzg.multiply(kzg.G1, int(c_zeta + gamma)))
        factor_2 = ((a_zeta + beta * s_sigma1_zeta + gamma)
                    * (b_zeta + beta * s_sigma2_zeta + gamma)
                    * z_omega_zeta)
        term_2 = kzg.multiply(c_poly_term, int(factor_2))

        perm_diff = kzg.add(term_1, kzg.neg(term_2))
        r_comm = kzg.add(r_comm, kzg.multiply(perm_diff, int(alpha)))

        # Copy-constraint term (reference :168-171).
        factor3 = alpha ** 2 * L1_zeta
        z_minus_1 = kzg.add(z_comm, kzg.neg(kzg.G1))
        r_comm = kzg.add(r_comm, kzg.multiply(z_minus_1, int(factor3)))

        # Quotient subtraction (reference :173-178).
        t_combined = kzg.add(quotient_commitments[0],
                             kzg.multiply(quotient_commitments[1], int(zeta ** n)))
        t_combined = kzg.add(t_combined,
                             kzg.multiply(quotient_commitments[2],
                                          int(zeta ** (2 * n))))
        r_comm = kzg.add(r_comm, kzg.neg(kzg.multiply(t_combined, int(ZH_zeta))))

        # Batch verification (reference :180-213), r = u.
        zeta_commitments = [r_comm] + wire_commitments + [s_sigma1_comm, s_sigma2_comm]
        zeta_evaluations = [Fq(0), a_zeta, b_zeta, c_zeta,
                            s_sigma1_zeta, s_sigma2_zeta]
        zw_commitments = [z_comm]
        zw_evaluations = [z_omega_zeta]

        return kzg.batch_check(
            rk,
            [zeta_commitments, zw_commitments],
            [zeta, zeta * g],
            [zeta_evaluations, zw_evaluations],
            [W_z, W_zw],
            [v, v],
            u,
        )
