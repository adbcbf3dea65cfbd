"""KZG polynomial commitment scheme.

Behavioral equivalent of the reference's ``kzg.py`` (class KZG): ``setup``,
``commit``, ``open``, ``check``, ``batch_check`` with identical protocol
semantics — xi^(i+1) batch combination (kzg.py:147-150), zero-coefficient
skipping in commit (kzg.py:113-114), the transformed two-pairing batch
equation (kzg.py:266-288) — re-hosted on this framework's field/curve/pairing
stack and with every randomness site injectable.

Backends:
  * ``"host"``  — pure-Python compat path whose scalar-multiplication chains
    reproduce py_ecc representatives (transcript-bit-exact mode).
  * ``"cuda"``  — the SRS as a ``DeviceSRS`` on ``device`` (``ops/srs.py``)
    and commitments through the device MSM (``ops/msm.py``), normalized to
    canonical projective form (x, y, 1).
The mode is selected per-instance; protocol code is backend-agnostic.
This is the port's copy of the JAX package's ``models/kzg.py``, with its
"tpu" backend replaced by "cuda".
"""

from __future__ import annotations

from .. import constants as C
from ..rng import Rng, DEFAULT_RNG
from ..ops.host import curve as pc
from ..ops.host.field import FieldElement, scalar_field, base_field
from ..ops.host.pairing import PairingContext
from ..ops.host.poly import Poly
from ..ops.host.tower import tower_fields


class KZG:
    def __init__(self, curve_type: str = "bn254", backend: str = "host",
                 rng: Rng | None = None,
                 normalize_commitments: bool | None = None,
                 device="cuda"):
        self.curve_type = curve_type
        self.backend = backend
        self.device = device     # where the "cuda" backend keeps the SRS
        self.device_srs = None   # the cuda backend's last ``setup``
        self.rng = rng if rng is not None else DEFAULT_RNG
        # Fast mode serializes commitments canonically as (x, y, 1); compat
        # (host) mode keeps raw projective representatives for py_ecc
        # transcript parity.  The cuda backend always normalizes.
        if normalize_commitments is None:
            normalize_commitments = (backend == "cuda")
        self.normalize_commitments = normalize_commitments

        # Field setup (reference kzg.py:52-54).
        self.Fq = scalar_field(curve_type)      # reference names GF(r) "Fq"
        self.Fr = self.Fq                        # alias with the honest name
        self.curve_order = self.Fq.modulus
        self._Fp = base_field(curve_type)

        # Curve generators (reference kzg.py:40-49 binds py_ecc's).
        Fq2, _, _ = tower_fields(self._Fp.modulus,
                                 C.BN254_XI if curve_type == "bn254" else C.BLS12_381_XI)
        self._Fq2 = Fq2
        if curve_type == "bn254":
            g1, g2x, g2y = C.BN254_G1, C.BN254_G2_X, C.BN254_G2_Y
        elif curve_type == "bls12_381":
            g1, g2x, g2y = C.BLS12_381_G1, C.BLS12_381_G2_X, C.BLS12_381_G2_Y
        else:
            raise ValueError(f"Unsupported curve type: {curve_type}")
        self.G1 = (self._Fp(g1[0]), self._Fp(g1[1]), self._Fp(1))
        self.G2 = (Fq2(*g2x), Fq2(*g2y), Fq2.one())
        self.Z1 = pc.identity(self._Fp)
        self.Z2 = pc.identity(Fq2)

        self.add = pc.add
        self.neg = pc.neg
        self.multiply = pc.multiply
        self.eq = pc.eq

        self._pairing_ctx = PairingContext(curve_type)

        # Polynomial ring handles (reference kzg.py:53-54).
        self.R = lambda coeffs=(): Poly(self.Fq, coeffs if not isinstance(coeffs, (int, FieldElement)) else [coeffs])
        self.X = Poly.x(self.Fq)

    # ------------------------------------------------------------------
    def pairing(self, q, p):
        """py_ecc argument order: pairing(G2 point, G1 point)."""
        return self._pairing_ctx.pairing(q, p)

    def _pairing_eq(self, q1, p1, q2, p2) -> bool:
        """e(q1, p1) == e(q2, p2), using the native C++ library when
        available (bn254 only) with the pure-Python tower as fallback."""
        if self.curve_type == "bn254":
            from ..utils import native
            if native.available():
                def aff1(pt):
                    a = pc.normalize(pt)
                    return None if a is None else (int(a[0]), int(a[1]))

                def aff2(pt):
                    a = pc.normalize(pt)
                    if a is None:
                        return None
                    return ((a[0].c0, a[0].c1), (a[1].c0, a[1].c1))

                return native.pairing_eq(aff2(q1), aff1(p1),
                                         aff2(q2), aff1(p2))
        return self.pairing(q1, p1) == self.pairing(q2, p2)

    # ------------------------------------------------------------------
    def setup(self, max_degree: int, tau: int | None = None):
        """Generate the SRS: ck = [G1, tau*G1, ..., tau^d*G1], rk = tau*G2
        (reference kzg.py:56-78).  ``tau`` injectable for reproducibility."""
        if tau is None:
            tau = int(self.rng.random_element(self.Fq))
        tau = tau % self.curve_order

        if self.backend == "cuda":
            from ..ops import srs as srs_mod
            powers_of_tau_G1 = srs_mod.setup_g1_powers(
                self, tau, max_degree, device=self.device)
        else:
            powers_of_tau_G1 = [self.G1]
            tau_f = self.Fq(tau)
            for i in range(1, max_degree + 1):
                powers_of_tau_G1.append(self.multiply(self.G1, int(tau_f ** i)))
        tau_G2 = self.multiply(self.G2, tau)
        if self.backend == "cuda":
            self.device_srs = powers_of_tau_G1
        return (powers_of_tau_G1, tau_G2)

    # ------------------------------------------------------------------
    def cells_core(self, n: int, cell_width: int):
        """The cuda backend's FK20 core over the last ``setup``'s SRS for
        polynomials of degree < n and cells of ``cell_width`` values, its
        set-up table built once (``ops/fk20.py``)."""
        from ..ops.fk20 import cells_core
        if self.backend != "cuda":
            raise ValueError("cells and cell proofs need the cuda backend")
        return cells_core(self.device_srs, n, cell_width)

    def _blob_coeffs(self, blobs, core):
        from ..ops.ntt import ntt_context
        be = core.be
        mont = be.to_mont(blobs.reshape(8, -1)).reshape(blobs.shape)
        return ntt_context(self.curve_type, core.n, core.ctx.device).intt(mont)

    def _cells(self, blobs, cell_width, coeffs):
        from ..ops.fk20 import FIELD_ELEMENTS_PER_CELL
        from ..utils.profiling import span
        core = self.cells_core(blobs.shape[-1],
                               cell_width or FIELD_ELEMENTS_PER_CELL)
        if coeffs is None:
            coeffs = self._blob_coeffs(blobs, core)
        with span("fk20.extend"):
            return core, coeffs, core.cells_dev(core.eval_dev(coeffs,
                                                              core.order))

    def compute_cells(self, blobs, cell_width: int | None = None,
                      coeffs=None):
        """EIP-7594 ``compute_cells`` for k blobs at once: blobs (8, k, n)
        canonical Fr words, the values at w^0 .. w^(n-1) (natural order),
        -> the cells (8, k, 2n / l, l) canonical words on the device, each
        cell the l values on its coset, in the specs' order.  ``coeffs``:
        the blobs' coefficients (8, k, n) Montgomery, where the caller has
        them."""
        return self._cells(blobs, cell_width, coeffs)[2]

    def compute_cells_and_kzg_proofs(self, blobs, cell_width: int | None = None,
                                     coeffs=None):
        """EIP-7594 ``compute_cells_and_kzg_proofs`` for k blobs at once, the
        proofs by FK20 (``ops/fk20.py``): -> (cells as ``compute_cells``,
        proofs: per blob its 2n / l cells' proofs as affine int pairs, None
        for the identity)."""
        core, coeffs, cells = self._cells(blobs, cell_width, coeffs)
        flat = core.ctx.curve.to_affine_ints(core.proofs_dev(coeffs))
        N, k = core.cells, blobs.shape[1]
        return cells, [flat[b * N:(b + 1) * N] for b in range(k)]

    # ------------------------------------------------------------------
    def _as_polys(self, polynomials) -> list[Poly]:
        out = []
        for poly in polynomials:
            if isinstance(poly, Poly):
                out.append(poly)
            else:
                out.append(Poly(self.Fq, poly))
        return out

    def commit(self, ck, polynomials):
        """Commit to each polynomial: C = sum_i c_i * (tau^i G1), skipping
        zero coefficients (reference kzg.py:80-120, skip at :113-114)."""
        sage_like = self._as_polys(polynomials)
        max_degree = len(ck) - 1
        commitments = []
        for poly in sage_like:
            if poly.degree() > max_degree:
                raise ValueError(
                    f"Polynomial degree {poly.degree()} exceeds maximum allowed degree {max_degree}"
                )
            if self.backend == "cuda":
                commitments.append(self._device_commit(ck, poly))
                continue
            commitment = self.Z1
            for i, coeff in enumerate(poly.list()):
                if coeff == 0:
                    continue
                term = self.multiply(ck[i], int(coeff))
                commitment = self.add(commitment, term)
            if self.normalize_commitments:
                commitment = self._normalize_point(commitment)
            commitments.append(commitment)
        return commitments

    def _normalize_point(self, pt):
        aff = pc.normalize(pt)
        if aff is None:
            return self.Z1
        Fp = type(self.G1[0])
        return (Fp(int(aff[0])), Fp(int(aff[1])), Fp(1))

    def _device_commit(self, ck, poly: Poly):
        from ..ops import msm as msm_mod
        return msm_mod.commit(self, ck, poly)

    # ------------------------------------------------------------------
    def open(self, ck, polynomials, z, xi):
        """Batched opening proof at z with challenge xi:
        p = sum_i xi^(i+1) p_i, witness w = (p - p(z)) / (X - z), return
        commit(w) (reference kzg.py:122-159)."""
        polys = self._as_polys(polynomials)
        z = self.Fq(z)
        xi = self.Fq(xi)
        combined = Poly(self.Fq)
        for i, poly in enumerate(polys):
            combined = combined + poly * (xi ** (i + 1))
        witness = (combined - combined(z)) / Poly(self.Fq, [-z, 1])
        return self.commit(ck, [witness])[0]

    # ------------------------------------------------------------------
    def check(self, rk, commitments, z, evaluations, proof, xi) -> bool:
        """Single-point batched verification via one pairing equation
        e(C - v G1, G2) == e(pi, tau G2 - z G2) (reference kzg.py:161-211)."""
        tau_G2 = rk
        z = self.Fq(z)
        xi = self.Fq(xi)

        combined_commitment = self.Z1
        for i, comm in enumerate(commitments):
            term = self.multiply(comm, int(xi ** (i + 1)))
            combined_commitment = self.add(combined_commitment, term)

        combined_evaluation = self.Fq(0)
        for i, eval_i in enumerate(evaluations):
            combined_evaluation = combined_evaluation + (xi ** (i + 1)) * self.Fq(int(eval_i))

        v_G1 = self.multiply(self.G1, int(combined_evaluation))
        C_minus_v = self.add(combined_commitment, self.neg(v_G1))
        z_G2 = self.multiply(self.G2, int(z))
        tauG2_minus_z = self.add(tau_G2, self.neg(z_G2))

        return self._pairing_eq(self.G2, C_minus_v, tauG2_minus_z, proof)

    # ------------------------------------------------------------------
    def batch_check(self, rk, commitments_list, z_list, evaluations_list,
                    proof_list, xi_list, r=None) -> bool:
        """Fold k verification instances into two pairings with powers
        r^(i+1); fresh random r when not supplied (reference kzg.py:213-288,
        transformed equation at :266-272)."""
        tau_G2 = rk
        if r is None:
            r = self.rng.random_element(self.Fq)
        r = self.Fq(int(r))

        left_acc = self.Z1
        right_acc = self.Z1
        for i, (commitments, z, evaluations, proof, xi) in enumerate(
            zip(commitments_list, z_list, evaluations_list, proof_list, xi_list)
        ):
            z = self.Fq(int(z))
            xi = self.Fq(int(xi))
            combined_commitment = self.Z1
            combined_evaluation = self.Fq(0)
            for j, comm in enumerate(commitments):
                xi_power = xi ** (j + 1)
                combined_commitment = self.add(
                    combined_commitment, self.multiply(comm, int(xi_power))
                )
                combined_evaluation = combined_evaluation + xi_power * self.Fq(int(evaluations[j]))

            v_G1 = self.multiply(self.G1, int(combined_evaluation))
            C_minus_v = self.add(combined_commitment, self.neg(v_G1))
            z_pi = self.multiply(proof, int(z))
            term_left = self.add(C_minus_v, z_pi)

            r_power = int(r ** (i + 1))
            left_acc = self.add(left_acc, self.multiply(term_left, r_power))
            right_acc = self.add(right_acc, self.multiply(proof, r_power))

        return self._pairing_eq(self.G2, left_acc, tau_G2, right_acc)
