"""PLONK prover on the device (PyTorch + the port's CUDA kernels).

Counterpart of ``kzg_snark_tpu/models/plonk/device.py``: the protocol of the
host prover (the port's copy, ``models/plonk/prover.py``) with the same
transcript schedule, RNG draw order and proof dict, and every O(n)
computation on the device:

  * wire and permutation interpolation -> iNTT (ops/ntt, K1-K5)
  * grand product -> blocked prefix scan of K1 products
  * quotient -> pointwise on the 4n coset, times a precomputed 1/v_H table
  * z(omega X) -> roll by 4 on the 4n coset
  * commitments -> MSM over the DeviceSRS (ops/msm: K6-K9)
  * openings -> the suffix-scan identity
    w_j = zeta^-(j+1) sum_{i>j} c_i zeta^i

Given the same Rng seed and tau, the proof is byte-identical to the host
prover's with ``normalize_commitments=True``.  The JAX version compiled each
round with ``jax.jit``; here each round is a direct method call.  Under
``KZG_TPU_CHECKED`` (the core is cached by the flag) the rounds compute
over the checked backend and each round method's output is validated
under ``"plonk.<name>"``, the counterpart of the JAX ``jit_method``
wrapper; the values, and so the proof, are those of an unchecked run.

The prove runs in phases (``DeviceProver._phase``), each a span
``plonk.<phase>`` under a profiler; with ``collect_timings`` the device is
synced at each phase's close and the phase timed.  ``eval_dev``,
``open_dev`` and ``combine_weighted`` are the spans ``kzg.eval``,
``kzg.open`` and ``kzg.combine``.
"""

from __future__ import annotations

import contextlib
import time

import torch

from ...ops.fr import (CheckedFieldBackend, canonical_device,
                       checked_enabled, fr_backend, validate_tree_canonical)
from ...ops.host.field import scalar_field
from ...ops.msm import FUSED_THRESHOLD, affine_to_host, msm_context
from ...ops.ntt import ntt_context
from ...ops.srs import DeviceSRS
from ...rng import Rng
from ...transcript import Transcript
from ...utils.build import count_sync
from ...utils.profiling import span
from ..kzg import KZG


ROUNDS = ("wire_poly", "z_poly", "to_coset_evals", "quotient_coeffs",
          "round3", "eval_dev", "open_at", "open_dev", "combine_weighted")


def _validated(be, method, op: str):
    """``method`` with every tensor of its output validated under ``op``."""
    def checked(*args, **kwargs):
        return validate_tree_canonical(be, method(*args, **kwargs), op)
    return checked


class PlonkDeviceCore:
    """Precomputed domain tables and the round computations for one
    (curve, n, device)."""

    _CACHE: dict = {}

    def __new__(cls, curve_type: str, n: int, device):
        device = canonical_device(device)
        key = (curve_type, n, str(device), checked_enabled())
        if key in cls._CACHE:
            return cls._CACHE[key]
        self = super().__new__(cls)
        self._init(curve_type, n, device)
        cls._CACHE[key] = self
        return self

    def _init(self, curve_type: str, n: int, device: torch.device) -> None:
        self.curve_type = curve_type
        self.n = n
        self.device = device
        self.be = fr_backend(curve_type, device)
        be = self.be
        Fr = scalar_field(curve_type)

        self.ntt_n = ntt_context(curve_type, n, device)
        self.ntt_4n = ntt_context(curve_type, 4 * n, device)
        self.g = self.ntt_n.root                    # |H| generator
        self.w4 = self.ntt_4n.root
        self.shift = Fr.generator                   # coset shift s
        s = self.shift

        # Coset points x_i = s w4^i and derived tables, all (8, 4n).
        self.x4 = be.mul(self.ntt_4n.powers(self.w4), be.scalar(s))
        vh4 = be.sub(be.pow_const(self.x4, n), be.one_mont)
        self.inv_vh4 = be.inv(vh4)
        # L1(x) = (x^n - 1) / (n (x - 1)) on the coset.
        denom = be.mul(be.sub(self.x4, be.one_mont), be.scalar(n))
        self.L1_4 = be.mul(vh4, be.inv(denom))
        self.h_pows = self.ntt_n.powers(self.g)
        if isinstance(be, CheckedFieldBackend):
            for name in ROUNDS:
                setattr(self, name, _validated(be, getattr(self, name),
                                               f"plonk.{name}"))

    # ------------------------------------------------------------------
    def wire_poly(self, values, b_hi, b_lo):
        """(b_hi X + b_lo) v_H + iNTT(values): coeffs (8, n+2)."""
        be = self.be
        base = self.ntt_n.intt(values)
        lo0 = be.sub(base[:, :1], b_lo)
        lo1 = be.sub(base[:, 1:2], b_hi)
        return torch.cat([lo0, lo1, base[:, 2:], b_lo, b_hi], dim=1)

    def z_poly(self, a_v, b_v, c_v, s1_v, s2_v, s3_v, beta, gamma,
               k1, k2, b7, b8, b9):
        """Grand product + (b7 X^2 + b8 X + b9) v_H: coeffs (8, n+3)."""
        be = self.be
        h = self.h_pows

        def factor(w_v, mult):
            return be.add(be.add(w_v, be.mul(be.mul(beta, mult), h)), gamma)

        def factor_sig(w_v, sig):
            return be.add(be.add(w_v, be.mul(beta, sig)), gamma)

        num = be.mul(be.mul(factor(a_v, be.one_mont), factor(b_v, k1)),
                     factor(c_v, k2))
        den = be.mul(be.mul(factor_sig(a_v, s1_v), factor_sig(b_v, s2_v)),
                     factor_sig(c_v, s3_v))
        ratio = be.mul(num, be.batch_inv(den))
        z_vals = be.exclusive_prefix_prod(ratio)           # z(w^i)
        base = self.ntt_n.intt(z_vals)
        c0 = be.sub(base[:, :1], b9)
        c1 = be.sub(base[:, 1:2], b8)
        c2 = be.sub(base[:, 2:3], b7)
        return torch.cat([c0, c1, c2, base[:, 3:], b9, b8, b7], dim=1)

    def to_coset_evals(self, coeffs):
        """coeffs (8, m <= 4n) -> evaluations on the shift * H4 coset."""
        m = coeffs.shape[1]
        if m < 4 * self.n:
            coeffs = torch.cat([coeffs, torch.zeros(
                (coeffs.shape[0], 4 * self.n - m), dtype=coeffs.dtype,
                device=coeffs.device)], dim=1)
        return self.ntt_4n.coset_ntt(coeffs, self.shift)

    def quotient_coeffs(self, a4, b4, c4, z4, qM4, qL4, qR4, qO4, qC4,
                        s14, s24, s34, pi4, alpha, beta, gamma, k1, k2):
        """t = (gate + alpha perm + alpha^2 L1-term) / v_H, pointwise on
        the coset; returns coeffs (8, 4n)."""
        be = self.be
        x4 = self.x4
        gate = be.add(
            be.add(be.add(be.mul(be.mul(a4, b4), qM4), be.mul(a4, qL4)),
                   be.add(be.mul(b4, qR4), be.mul(c4, qO4))),
            be.add(pi4, qC4))
        z4_shift = torch.roll(z4, -4, dims=1)              # z(g x)
        t1 = be.add(be.add(a4, be.mul(beta, x4)), gamma)
        t2 = be.add(be.add(b4, be.mul(be.mul(beta, k1), x4)), gamma)
        t3 = be.add(be.add(c4, be.mul(be.mul(beta, k2), x4)), gamma)
        u1 = be.add(be.add(a4, be.mul(beta, s14)), gamma)
        u2 = be.add(be.add(b4, be.mul(beta, s24)), gamma)
        u3 = be.add(be.add(c4, be.mul(beta, s34)), gamma)
        perm = be.sub(be.mul(be.mul(be.mul(t1, t2), t3), z4),
                      be.mul(be.mul(be.mul(u1, u2), u3), z4_shift))
        l1_term = be.mul(be.sub(z4, be.one_mont), self.L1_4)
        alpha2 = be.mul(alpha, alpha)
        num = be.add(gate, be.add(be.mul(alpha, perm),
                                  be.mul(alpha2, l1_term)))
        t4 = be.mul(num, self.inv_vh4)
        return self.ntt_4n.coset_intt(t4, self.shift)

    def eval_at(self, coeffs, point: int):
        """sum c_i z^i via a powers table and a tree sum."""
        be = self.be
        return be.sum_reduce(be.mul(coeffs, be.powers_of(point,
                                                         coeffs.shape[1])))

    def open_at(self, coeffs, point: int):
        """Witness (p - p(z)) / (X - z) at an int point by the suffix-scan
        identity w_j = z^-(j+1) sum_{i>j} c_i z^i: coeffs (8, m) ->
        (8, m - 1); z^-1 on the host."""
        be = self.be
        m = coeffs.shape[1]
        z = point % be.modulus
        z_inv = pow(z, -1, be.modulus)
        return self._open(coeffs, be.powers_of(z, m),
                          be.mul(be.powers_of(z_inv, m), be.scalar(z_inv)))

    def _open(self, coeffs, pows, inv_pows):
        """The witness from [1, z, ..] and [z^-1, z^-2, ..], (8, m) each."""
        be = self.be
        suffix = be.suffix_sums_exclusive(be.mul(coeffs, pows))
        return be.mul(suffix, inv_pows)[:, :coeffs.shape[1] - 1]

    def powers_dev(self, z_scalar, count: int):
        """[1, z, ..., z^(count-1)] (8, count) from an (8, 1) scalar: a
        product scan of z repeated (read with step 0, never copied)."""
        be = self.be
        return be.exclusive_prefix_prod(z_scalar.expand(be.num_limbs, count))

    def eval_dev(self, coeffs, z_scalar):
        with span("kzg.eval"):
            be = self.be
            return be.sum_reduce(be.mul(coeffs, self.powers_dev(
                z_scalar, coeffs.shape[1])))

    def open_dev(self, coeffs, z_scalar):
        """``open_at`` at an (8, 1) Montgomery device scalar."""
        with span("kzg.open"):
            m = coeffs.shape[1]
            z_inv = self.be.inv(z_scalar)
            return self._open(coeffs, self.powers_dev(z_scalar, m),
                              self.be.mul(self.powers_dev(z_inv, m), z_inv))

    def combine_weighted(self, arrays: list, weights: list):
        """sum_i weights[i] * arrays[i], arrays zero-padded to the longest;
        weights are (8, 1) Montgomery scalars."""
        with span("kzg.combine"):
            be = self.be
            max_len = max(a.shape[1] for a in arrays)
            acc = torch.zeros((be.num_limbs, max_len), dtype=torch.int32,
                              device=self.device)
            for arr, w in zip(arrays, weights):
                m = arr.shape[1]
                if m < max_len:
                    arr = torch.cat([arr, torch.zeros(
                        (be.num_limbs, max_len - m), dtype=torch.int32,
                        device=self.device)], dim=1)
                acc = be.add(acc, be.mul(arr, w))
            return acc

    def round3(self, a_poly, b_poly, c_poly, z_poly, pi_coeffs,
               qM4, qL4, qR4, qO4, qC4, s14, s24, s34,
               alpha, beta, gamma, k1, k2, b10, b11):
        """Quotient and its t_lo / t_mid / t_hi split with cross-blinding."""
        be = self.be
        n = self.n
        to4 = self.to_coset_evals
        t = self.quotient_coeffs(
            to4(a_poly), to4(b_poly), to4(c_poly), to4(z_poly),
            qM4, qL4, qR4, qO4, qC4, s14, s24, s34, to4(pi_coeffs),
            alpha, beta, gamma, k1, k2)
        t_lo = torch.cat([t[:, :n], b10], dim=1)
        t_mid = torch.cat([be.sub(t[:, n:n + 1], b10), t[:, n + 1:2 * n],
                           b11], dim=1)
        t_hi = torch.cat([be.sub(t[:, 2 * n:2 * n + 1], b11),
                          t[:, 2 * n + 1:3 * n + 6]], dim=1)
        return t_lo, t_mid, t_hi


class DeviceProver:
    """PLONK prover with device compute: the host Prover's prove() contract,
    transcript and proof dict."""

    def __init__(self, curve_type: str = "bn254", rng: Rng | None = None,
                 collect_timings: bool = False, device="cuda"):
        self.device = canonical_device(device)
        self.kzg = KZG(curve_type=curve_type, backend="cuda", rng=rng,
                       device=self.device)
        self.rng = self.kzg.rng
        self.collect_timings = collect_timings
        self.timings: dict[str, float] = {}

    @contextlib.contextmanager
    def _phase(self, name: str):
        """One phase of the prove, under the span ``plonk.<name>``.  With
        timings on, wait for the device at its close, so the phases add up
        to the wall time, and record its time; with them off, neither."""
        t0 = time.perf_counter()
        with span(f"plonk.{name}"):
            yield
            if self.collect_timings:
                count_sync("plonk.phase")
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        if self.collect_timings:
            self.timings[name] = self.timings.get(name, 0.0) + \
                time.perf_counter() - t0

    # -- commitments ------------------------------------------------------
    def _commit_many(self, ck: DeviceSRS, coeff_list: list) -> list:
        """Commit several Montgomery coefficient arrays in one batched MSM
        (zero-padded to the longest) -> host projective tuples."""
        ctx = msm_context(self.kzg.curve_type, self.device)
        be = ctx.scalar_backend
        m = max(c.shape[1] for c in coeff_list)
        if m > len(ck):
            raise ValueError(f"{m} coefficients exceed the SRS ({len(ck)})")
        # The JAX prover's slice: exact from the bucket threshold up, else
        # the next power of two (so the MSM route matches).
        pts = ck.points[..., :m] if m >= FUSED_THRESHOLD else \
            ck.slice_pow2(m)
        width = pts.shape[-1]
        rows = []
        for c in coeff_list:
            canon = be.from_mont(c)
            if c.shape[1] < width:
                canon = torch.cat([canon, torch.zeros(
                    (be.num_limbs, width - c.shape[1]), dtype=torch.int32,
                    device=self.device)], dim=1)
            rows.append(canon)
        result = ctx.msm(pts, torch.stack(rows))
        return [affine_to_host(self.kzg, a)
                for a in ctx.curve.to_affine_ints(result)]

    def _commit_coeffs(self, ck: DeviceSRS, coeffs_mont):
        return self._commit_many(ck, [coeffs_mont])[0]

    # -- the prover -------------------------------------------------------
    def prove(self, ipk, x, w):
        kzg = self.kzg
        Fq = kzg.Fq
        ck = ipk["ck"]
        if not isinstance(ck, DeviceSRS):
            raise TypeError("DeviceProver needs an ipk with a DeviceSRS")
        n = ipk["subgroups"]["n"]
        g = ipk["subgroups"]["g"]
        k1 = ipk["subgroups"]["k1"]
        k2 = ipk["subgroups"]["k2"]

        self.timings = {}
        with self._phase("setup"):
            core = PlonkDeviceCore(kzg.curve_type, n, self.device)
            be = core.be
            if int(g) != core.g:
                raise ValueError("ipk domain generator differs from the "
                                 "deterministic device domain")
            dev = self._device_index_polys(ipk, core)

        with self._phase("round1_wires"):
            transcript = Transcript("plonk-proof", Fq)
            transcript.append_message("public-inputs", list(x))
            full_witness = [int(Fq(int(v))) for v in list(x) + list(w)]

            # The host prover builds a throwaway encoder whose update_state
            # rejection-samples coset multipliers from the shared RNG:
            # replay those draws so the blinding stream stays aligned.
            while True:
                k1_dummy = self.rng.random_element(Fq)
                k2_dummy = self.rng.random_element(Fq)
                if (k1_dummy != 0 and k2_dummy != 0 and k1_dummy ** n != 1
                        and k2_dummy ** n != 1
                        and (k1_dummy / k2_dummy) ** n != 1):
                    break

            pi_vals = [(-Fq(int(v))).n for v in x] + [0] * (n - len(x))
            pi_coeffs = core.ntt_n.intt(be.from_ints(pi_vals))

            # ----- Round 1 -----
            b1, b2, b3, b4, b5, b6, b7, b8, b9 = [
                self.rng.random_element(Fq) for _ in range(9)]
            sc = lambda v: be.scalar(int(v))                # noqa: E731

            a_vals = be.from_ints(full_witness[:n])
            b_vals = be.from_ints(full_witness[n:2 * n])
            c_vals = be.from_ints(full_witness[2 * n:3 * n])
            a_poly = core.wire_poly(a_vals, sc(b1), sc(b2))
            b_poly = core.wire_poly(b_vals, sc(b3), sc(b4))
            c_poly = core.wire_poly(c_vals, sc(b5), sc(b6))
        with self._phase("round1_commits_msm"):
            wire_commitments = self._commit_many(ck, [a_poly, b_poly,
                                                      c_poly])
            a_commit, b_commit, c_commit = wire_commitments
            transcript.append_message("round1-commitments", wire_commitments)

        # ----- Round 2 -----
        with self._phase("round2_grand_product"):
            beta = transcript.get_challenge("beta")
            gamma = transcript.get_challenge("gamma")
            z_poly = core.z_poly(a_vals, b_vals, c_vals,
                                 dev["sig1_vals"], dev["sig2_vals"],
                                 dev["sig3_vals"], sc(beta), sc(gamma),
                                 sc(k1), sc(k2), sc(b7), sc(b8), sc(b9))
        with self._phase("round2_commit_msm"):
            z_commit = self._commit_coeffs(ck, z_poly)
            transcript.append_message("round2-commitment", z_commit)

        # ----- Round 3 -----
        with self._phase("round3_quotient_ntt"):
            alpha = transcript.get_challenge("alpha")
            b10 = self.rng.random_element(Fq)
            b11 = self.rng.random_element(Fq)
            t_lo, t_mid, t_hi = core.round3(
                a_poly, b_poly, c_poly, z_poly, pi_coeffs,
                dev["qM4"], dev["qL4"], dev["qR4"], dev["qO4"], dev["qC4"],
                dev["s14"], dev["s24"], dev["s34"],
                sc(alpha), sc(beta), sc(gamma), sc(k1), sc(k2),
                sc(b10), sc(b11))
        with self._phase("round3_commits_msm"):
            t_commitments = self._commit_many(ck, [t_lo, t_mid, t_hi])
            t_lo_commit, t_mid_commit, t_hi_commit = t_commitments
            transcript.append_message("round3-commitments", t_commitments)

        # ----- Round 4 -----
        with self._phase("round4_evals"):
            zeta = transcript.get_challenge("zeta")
            zeta_i = int(zeta)

            def ev(coeffs, pt):
                return Fq(be.to_ints(core.eval_dev(coeffs, sc(pt)))[0])

            a_zeta = ev(a_poly, zeta_i)
            b_zeta = ev(b_poly, zeta_i)
            c_zeta = ev(c_poly, zeta_i)
            s_sigma1_zeta = ev(dev["sig1_coeffs"], zeta_i)
            s_sigma2_zeta = ev(dev["sig2_coeffs"], zeta_i)
            z_omega_zeta = ev(z_poly, int(zeta * Fq(int(g))))
            evaluations = [a_zeta, b_zeta, c_zeta, s_sigma1_zeta,
                           s_sigma2_zeta, z_omega_zeta]
            transcript.append_message("round4-evaluations", evaluations)

        # ----- Round 5 -----
        with self._phase("round5_openings"):
            v = transcript.get_challenge("v")
            r_poly = self._linearization(
                core, dev, z_poly, t_lo, t_mid, t_hi, a_zeta, b_zeta,
                c_zeta, s_sigma1_zeta, s_sigma2_zeta, z_omega_zeta, alpha,
                beta, gamma, zeta, Fq(int(k1)), Fq(int(k2)), pi_coeffs, n)
            W_z = self._open(ck, core, [r_poly, a_poly, b_poly, c_poly,
                                        dev["sig1_coeffs"],
                                        dev["sig2_coeffs"]],
                             zeta_i, int(v))
            W_zw = self._open(ck, core, [z_poly], int(zeta * Fq(int(g))),
                              int(v))

        return {
            "commitments": {
                "a": a_commit, "b": b_commit, "c": c_commit,
                "z": z_commit,
                "t_lo": t_lo_commit, "t_mid": t_mid_commit,
                "t_hi": t_hi_commit,
            },
            "evaluations": {
                "a": a_zeta, "b": b_zeta, "c": c_zeta,
                "s_sigma1": s_sigma1_zeta, "s_sigma2": s_sigma2_zeta,
                "z_omega": z_omega_zeta,
            },
            "kzg_proofs": {"W_z": W_z, "W_zw": W_zw},
        }

    # ------------------------------------------------------------------
    def _device_index_polys(self, ipk, core: PlonkDeviceCore) -> dict:
        """Convert (and cache) the ipk's index polynomials to tensors."""
        if "_device_cache" in ipk:
            return ipk["_device_cache"]
        be = core.be
        n = core.n
        polys = ipk["polynomials"]
        dev = {}
        coeff_key = {"S_sigma1": "sig1_coeffs", "S_sigma2": "sig2_coeffs",
                     "S_sigma3": "sig3_coeffs"}
        for name, key in [("qM", "qM4"), ("qL", "qL4"), ("qR", "qR4"),
                          ("qO", "qO4"), ("qC", "qC4"),
                          ("S_sigma1", "s14"), ("S_sigma2", "s24"),
                          ("S_sigma3", "s34")]:
            coeffs = be.from_ints([int(c) for c in polys[name].padded(n)])
            dev[key] = core.to_coset_evals(coeffs)
            dev[coeff_key.get(name, name + "_coeffs")] = coeffs
        sigma_star = ipk["sigma_star"]
        dev["sig1_vals"] = be.from_ints([int(s) for s in sigma_star[:n]])
        dev["sig2_vals"] = be.from_ints([int(s) for s in sigma_star[n:2 * n]])
        dev["sig3_vals"] = be.from_ints([int(s) for s in sigma_star[2 * n:]])
        ipk["_device_cache"] = dev
        return dev

    # ------------------------------------------------------------------
    def _linearization(self, core, dev, z_poly, t_lo, t_mid, t_hi,
                       a_zeta, b_zeta, c_zeta, s1_z, s2_z, zw_z,
                       alpha, beta, gamma, zeta, k1, k2, pi_coeffs, n):
        """r(X) as a scalar-weighted combination of committed coefficient
        arrays (reference plonk/prover.py:358-414)."""
        be = core.be
        Fq = self.kzg.Fq
        z_H_zeta = zeta ** n - 1
        L1_zeta = z_H_zeta / (Fq(n) * (zeta - 1))
        pi_zeta = Fq(be.to_ints(core.eval_at(pi_coeffs, int(zeta)))[0])

        s_gate_qM = a_zeta * b_zeta
        s_perm_z = alpha * ((a_zeta + beta * zeta + gamma)
                            * (b_zeta + beta * k1 * zeta + gamma)
                            * (c_zeta + beta * k2 * zeta + gamma))
        s3_factor = -alpha * ((a_zeta + beta * s1_z + gamma)
                              * (b_zeta + beta * s2_z + gamma) * zw_z)
        s_copy = alpha ** 2 * L1_zeta
        constant = pi_zeta + s3_factor * (c_zeta + gamma) - s_copy

        arrays = [dev["qM_coeffs"], dev["qL_coeffs"], dev["qR_coeffs"],
                  dev["qO_coeffs"], dev["qC_coeffs"], z_poly,
                  dev["sig3_coeffs"], t_lo, t_mid, t_hi]
        weight_ints = [s_gate_qM, a_zeta, b_zeta, c_zeta, Fq(1),
                       s_perm_z + s_copy, s3_factor * beta,
                       -z_H_zeta, -z_H_zeta * zeta ** n,
                       -z_H_zeta * zeta ** (2 * n)]
        weights = be.from_ints([int(v) for v in weight_ints])
        acc = core.combine_weighted(
            arrays, [weights[:, i:i + 1] for i in range(len(arrays))])
        const_col = be.add(acc[:, :1], be.scalar(int(constant)))
        return torch.cat([const_col, acc[:, 1:]], dim=1)

    def preprocess(self, qM, qL, qR, qO, qC, perm, max_degree: int,
                   tau: int | None = None):
        """Device-encoded indexing: the (ipk, ivk) contract and RNG draw
        order of ``models/plonk/indexer.Indexer.preprocess``, with the eight
        interpolations as iNTTs and the commitments as one batched MSM."""
        from .indexer import POLY_ORDER
        from ...ops.host.poly import Poly
        kzg = self.kzg
        Fq = kzg.Fq
        ck, rk = kzg.setup(max_degree, tau=tau)

        n = 1 << (len(qM) - 1).bit_length()
        core = PlonkDeviceCore(kzg.curve_type, n, self.device)
        be = core.be
        g = Fq(core.g)

        # Coset multipliers: the host encoder's rejection sampling.
        while True:
            k1 = self.rng.random_element(Fq)
            k2 = self.rng.random_element(Fq)
            if (k1 != 0 and k2 != 0 and k1 ** n != 1 and k2 ** n != 1
                    and (k1 / k2) ** n != 1):
                break

        H = [Fq(1)]
        for _ in range(n - 1):
            H.append(H[-1] * g)
        flat = H + [k1 * h for h in H] + [k2 * h for h in H]
        sigma_star = [flat[perm[i]] for i in range(3 * n)]

        def interp(values):
            vals = be.from_ints([int(Fq(int(v))) for v in values]
                                + [0] * (n - len(values)))
            return core.ntt_n.intt(vals)

        sources = {
            "qM": qM, "qL": qL, "qR": qR, "qO": qO, "qC": qC,
            "S_sigma1": sigma_star[:n], "S_sigma2": sigma_star[n:2 * n],
            "S_sigma3": sigma_star[2 * n:],
        }
        coeffs = {name: interp(sources[name]) for name in POLY_ORDER}
        polys = {name: Poly(Fq, be.to_ints(coeffs[name]))
                 for name in POLY_ORDER}
        commitments = dict(zip(POLY_ORDER, self._commit_many(
            ck, [coeffs[name] for name in POLY_ORDER])))

        ipk = {
            "ck": ck, "polynomials": polys, "commitments": commitments,
            "subgroups": {"H": H, "n": n, "g": g, "k1": k1, "k2": k2},
            "vanishing_poly": Poly.vanishing(Fq, n),
            "sigma_star": sigma_star,
        }
        ivk = {
            "rk": rk, "commitments": commitments,
            "subgroups": {"n": n, "g": g, "k1": k1, "k2": k2},
        }
        return ipk, ivk

    def _open(self, ck, core, coeff_list, point: int, xi: int):
        """Batched opening: combined = sum xi^(i+1) p_i, witness by the
        suffix-scan identity, commit (reference kzg.py:122-159)."""
        be = core.be
        xi_f = self.kzg.Fq(xi)
        weights = be.from_ints(
            [int(xi_f ** (i + 1)) for i in range(len(coeff_list))])
        acc = core.combine_weighted(
            coeff_list, [weights[:, i:i + 1] for i in range(len(coeff_list))])
        witness = core.open_dev(acc, be.scalar(point % be.modulus))
        return self._commit_coeffs(ck, witness)
