"""PLONK prover (Section 8.3, five rounds).

Behavioral equivalent of ``plonk/prover.py``: same round
structure, transcript labels ("plonk-proof", "public-inputs",
"round1-commitments", beta/gamma, "round2-commitment", alpha,
"round3-commitments", zeta, "round4-evaluations", v — reference :54-160),
same blinding shape b1..b11 (:72-75, :346), same proof dict (:188-210).

Idiomatic differences (host path): the quotient's permutation terms are
combined *before* the single exact division by v_H (the reference leans on
Sage fraction-field coercion at :297-316 where individual terms are not
polynomials); the grand product is a prefix scan.  The device pipeline computes
the quotient on a coset evaluation domain instead (see models' device path).
"""

from __future__ import annotations

from ...rng import Rng
from ...transcript import Transcript
from ...ops.host.fft import fft_interpolation
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
    def prove(self, ipk, x, w):
        if self.backend == "cuda":
            # Full device pipeline (NTT/MSM/scan on the GPU) — same protocol,
            # transcript, and RNG draw order; see models/plonk/device.py.
            from .device import DeviceProver
            dp = DeviceProver(curve_type=self.kzg.curve_type, rng=self.rng)
            return dp.prove(ipk, x, w)
        return self._prove_host(ipk, x, w)

    def _prove_host(self, ipk, x, w):
        ck = ipk["ck"]
        polynomials = ipk["polynomials"]
        H = ipk["subgroups"]["H"]
        n = ipk["subgroups"]["n"]
        g = ipk["subgroups"]["g"]
        k1 = ipk["subgroups"]["k1"]
        k2 = ipk["subgroups"]["k2"]
        v_H = ipk["vanishing_poly"]
        sigma_star = ipk["sigma_star"]
        Fq = self.kzg.Fq
        X = Poly.x(Fq)

        self.encoder = Encoder(Fq, rng=self.rng)

        transcript = Transcript("plonk-proof", Fq)
        transcript.append_message("public-inputs", list(x))

        full_witness = [Fq(int(v)) for v in list(x) + list(w)]

        # PI(X) via a throwaway encoder with empty selectors/permutation
        # (reference plonk/prover.py:62-68; the verifier does the same).
        empty_perm = [0] * (3 * n)
        empty_selectors = [Fq(0)] * n
        self.encoder.update_state(empty_selectors, empty_selectors,
                                  empty_selectors, empty_selectors,
                                  empty_selectors, empty_perm)
        PI = self.encoder.compute_public_input_poly([Fq(int(v)) for v in x])

        # ----- Round 1: wire polynomials (reference :70-93) -----
        b1, b2 = self.rng.random_element(Fq), self.rng.random_element(Fq)
        b3, b4 = self.rng.random_element(Fq), self.rng.random_element(Fq)
        b5, b6 = self.rng.random_element(Fq), self.rng.random_element(Fq)
        b7 = self.rng.random_element(Fq)
        b8 = self.rng.random_element(Fq)
        b9 = self.rng.random_element(Fq)

        a_values = full_witness[:n]
        b_values = full_witness[n:2 * n]
        c_values = full_witness[2 * n:3 * n]

        a_poly = Poly(Fq, [b2, b1]) * v_H + fft_interpolation(a_values, g)
        b_poly = Poly(Fq, [b4, b3]) * v_H + fft_interpolation(b_values, g)
        c_poly = Poly(Fq, [b6, b5]) * v_H + fft_interpolation(c_values, g)

        wire_polys = [a_poly, b_poly, c_poly]
        wire_commitments = self.kzg.commit(ck, wire_polys)
        a_commit, b_commit, c_commit = wire_commitments
        transcript.append_message("round1-commitments", wire_commitments)

        # ----- Round 2: permutation polynomial (reference :95-116) -----
        beta = transcript.get_challenge("beta")
        gamma = transcript.get_challenge("gamma")

        z_poly = self._compute_permutation_polynomial(
            a_values, b_values, c_values, sigma_star,
            beta, gamma, g, k1, k2, n, H, v_H, b7, b8, b9)

        L1 = (v_H * Fq(1)) / (Poly(Fq, [-1, 1]) * Fq(n))
        assert (L1 * (z_poly - 1)) % v_H == Poly(Fq), \
            "z_poly does not satisfy L1 condition"

        z_commit = self.kzg.commit(ck, [z_poly])[0]
        transcript.append_message("round2-commitment", z_commit)

        # ----- Round 3: quotient polynomial (reference :118-140) -----
        alpha = transcript.get_challenge("alpha")

        t_poly = self._compute_quotient_polynomial(
            a_poly, b_poly, c_poly, z_poly,
            polynomials["qM"], polynomials["qL"], polynomials["qR"],
            polynomials["qO"], polynomials["qC"],
            polynomials["S_sigma1"], polynomials["S_sigma2"],
            polynomials["S_sigma3"],
            alpha, beta, gamma, PI, v_H, n, g, k1, k2, L1)

        t_lo, t_mid, t_hi = self._split_quotient_polynomial(t_poly, n)

        t_polys = [t_lo, t_mid, t_hi]
        t_commitments = self.kzg.commit(ck, t_polys)
        t_lo_commit, t_mid_commit, t_hi_commit = t_commitments
        transcript.append_message("round3-commitments", t_commitments)

        # ----- Round 4: evaluations (reference :142-156) -----
        zeta = transcript.get_challenge("zeta")
        a_zeta = a_poly(zeta)
        b_zeta = b_poly(zeta)
        c_zeta = c_poly(zeta)
        s_sigma1_zeta = polynomials["S_sigma1"](zeta)
        s_sigma2_zeta = polynomials["S_sigma2"](zeta)
        z_omega_zeta = z_poly(zeta * g)

        evaluations = [a_zeta, b_zeta, c_zeta, s_sigma1_zeta, s_sigma2_zeta,
                       z_omega_zeta]
        transcript.append_message("round4-evaluations", evaluations)

        # ----- Round 5: openings (reference :158-185) -----
        v = transcript.get_challenge("v")

        r_poly = self._compute_linearization_polynomial(
            a_zeta, b_zeta, c_zeta, s_sigma1_zeta, s_sigma2_zeta, z_omega_zeta,
            polynomials["qM"], polynomials["qL"], polynomials["qR"],
            polynomials["qO"], polynomials["qC"], polynomials["S_sigma3"],
            z_poly, t_lo, t_mid, t_hi, alpha, beta, gamma, zeta, PI, n, k1, k2)
        assert r_poly(zeta) == 0, "r(zeta) should be zero"

        zeta_polys = [r_poly, a_poly, b_poly, c_poly,
                      polynomials["S_sigma1"], polynomials["S_sigma2"]]
        W_z = self.kzg.open(ck, zeta_polys, zeta, v)
        W_zw = self.kzg.open(ck, [z_poly], zeta * g, v)

        return {
            "commitments": {
                "a": a_commit, "b": b_commit, "c": c_commit,
                "z": z_commit,
                "t_lo": t_lo_commit, "t_mid": t_mid_commit, "t_hi": t_hi_commit,
            },
            "evaluations": {
                "a": a_zeta, "b": b_zeta, "c": c_zeta,
                "s_sigma1": s_sigma1_zeta, "s_sigma2": s_sigma2_zeta,
                "z_omega": z_omega_zeta,
            },
            "kzg_proofs": {"W_z": W_z, "W_zw": W_zw},
        }

    # ------------------------------------------------------------------
    def _compute_permutation_polynomial(self, a_values, b_values, c_values,
                                        sigma_star, beta, gamma, g, k1, k2,
                                        n, H, v_H, b7, b8, b9) -> Poly:
        """Grand-product accumulator z with (b7 X^2 + b8 X + b9) v_H blinding
        (reference plonk/prover.py:214-269)."""
        Fq = self.kzg.Fq
        z_blind = Poly(Fq, [b9, b8, b7]) * v_H

        z_values = [Fq(1)]
        for i in range(n - 1):
            num = ((a_values[i] + beta * H[i] + gamma)
                   * (b_values[i] + beta * k1 * H[i] + gamma)
                   * (c_values[i] + beta * k2 * H[i] + gamma))
            den = ((a_values[i] + beta * sigma_star[i] + gamma)
                   * (b_values[i] + beta * sigma_star[i + n] + gamma)
                   * (c_values[i] + beta * sigma_star[i + 2 * n] + gamma))
            if den == 0:
                raise ValueError(
                    "Denominator is zero in permutation polynomial calculation")
            z_values.append(z_values[-1] * (num / den))

        return z_blind + fft_interpolation(z_values, g)

    # ------------------------------------------------------------------
    def _compute_quotient_polynomial(self, a_poly, b_poly, c_poly, z_poly,
                                     qM, qL, qR, qO, qC,
                                     S_sigma1, S_sigma2, S_sigma3,
                                     alpha, beta, gamma, PI, v_H,
                                     n, g, k1, k2, L1) -> Poly:
        """t = (gate + alpha*perm1 - alpha*perm2 + alpha^2*L1-term) / v_H
        (reference plonk/prover.py:271-318).  perm1 and perm2 are combined
        before the single exact division — only their difference is
        divisible by v_H."""
        Fq = self.kzg.Fq
        X = Poly.x(Fq)

        gate = (a_poly * b_poly * qM + a_poly * qL + b_poly * qR
                + c_poly * qO + PI + qC)
        term1 = gate / v_H  # exact: gate constraints vanish on H

        z_shifted = z_poly.scale_argument(g)  # z(gX), reference :305
        perm_num = (z_poly
                    * (a_poly + X * beta + gamma)
                    * (b_poly + X * (beta * k1) + gamma)
                    * (c_poly + X * (beta * k2) + gamma)
                    - (a_poly + S_sigma1 * beta + gamma)
                    * (b_poly + S_sigma2 * beta + gamma)
                    * (c_poly + S_sigma3 * beta + gamma)
                    * z_shifted)
        term23 = (perm_num * alpha) / v_H  # exact: permutation argument

        # alpha^2 (z - 1) L1 / v_H == alpha^2 (z - 1) / (n (X - 1)), exact
        # because z(1) = 1.
        term4 = ((z_poly - 1) * (alpha ** 2)) / (Poly(Fq, [-1, 1]) * Fq(n))

        return term1 + term23 + term4

    # ------------------------------------------------------------------
    def _split_quotient_polynomial(self, t_poly: Poly, n: int):
        """t = t_lo + X^n t_mid + X^2n t_hi with cross-blinding b10, b11
        (reference plonk/prover.py:320-356)."""
        Fq = self.kzg.Fq
        # t has degree up to 3n+5 from the blinding terms; t_hi absorbs the
        # overflow (hence the reference's max_degree = n+5, main.py:85).
        t_coeffs = t_poly.padded(3 * n)

        b10 = self.rng.random_element(Fq)
        b11 = self.rng.random_element(Fq)

        t_lo = Poly(Fq, t_coeffs[:n]) + Poly.monomial(Fq, n, b10)
        t_mid = Poly(Fq, t_coeffs[n:2 * n]) - b10 + Poly.monomial(Fq, n, b11)
        t_hi = Poly(Fq, t_coeffs[2 * n:]) - b11

        X = Poly.x(Fq)
        assert t_poly == t_lo + X ** n * t_mid + X ** (2 * n) * t_hi, \
            "t(X) does not equal the sum of its parts"
        return t_lo, t_mid, t_hi

    # ------------------------------------------------------------------
    def _compute_linearization_polynomial(self, a_zeta, b_zeta, c_zeta,
                                          s_sigma1_zeta, s_sigma2_zeta,
                                          z_omega_zeta,
                                          qM, qL, qR, qO, qC, S_sigma3,
                                          z_poly, t_lo, t_mid, t_hi,
                                          alpha, beta, gamma, zeta, PI,
                                          n, k1, k2) -> Poly:
        """r(X) with the r(zeta) = 0 convention
        (reference plonk/prover.py:358-414)."""
        Fq = self.kzg.Fq
        z_H_zeta = zeta ** n - 1
        L1_zeta = z_H_zeta / (Fq(n) * (zeta - 1))
        PI_zeta = PI(zeta)

        term1 = (qM * (a_zeta * b_zeta) + qL * a_zeta + qR * b_zeta
                 + qO * c_zeta + PI_zeta + qC)
        term2 = z_poly * (alpha
                          * (a_zeta + beta * zeta + gamma)
                          * (b_zeta + beta * k1 * zeta + gamma)
                          * (c_zeta + beta * k2 * zeta + gamma))
        term3 = -((S_sigma3 * beta + (c_zeta + gamma))
                  * (alpha
                     * (a_zeta + beta * s_sigma1_zeta + gamma)
                     * (b_zeta + beta * s_sigma2_zeta + gamma)
                     * z_omega_zeta))
        term4 = (z_poly - 1) * (alpha ** 2 * L1_zeta)

        return (term1 + term2 + term3 + term4
                - (t_lo + t_mid * (zeta ** n) + t_hi * (zeta ** (2 * n)))
                * z_H_zeta)
