"""Marlin prover on the device (PyTorch + the port's CUDA kernels).

Counterpart of ``kzg_snark_tpu/models/marlin/device.py``: the protocol of
the host prover (the port's copy, ``models/marlin/prover.py``) with the
same transcript schedule, RNG draw order and proof dict, and the O(n) and
O(m) work on the device:

  * witness and linear-combination interpolation -> iNTT over H
  * sparse matvecs zA, zB, zC -> gather + modular segment sum over the
    static COO pattern (``ops/polydev.segment_sum_mod``)
  * w_poly = f / v_H_x -> pointwise division on a coset
  * t(X) -> evaluation over H,
    t(h) = n h^-1 v_H(alpha) sum_{row(kappa) = h} val(kappa)/(alpha - col(kappa)),
    grouped by the circuit's static row indices, one iNTT
  * h_0, h_1, h_2 -> NTT products and the block division by X^k - 1
  * a(X), b(X) -> pointwise products on the 8m domain
  * commitments and openings -> MSM over the DeviceSRS (``ops/msm``; the
    route follows the length) and the suffix-scan (X - z) division

Given the same Rng seed and tau, the proof is byte-identical to the host
prover's with ``normalize_commitments=True``.  The in-line identity checks
(sum over H, f_2's constant term) stay: they sync the host and are part of
the protocol.  The prove runs in phases, each a span ``marlin.<phase>``
under a profiler; with ``collect_timings`` the device is synced at each
phase's close and the phase timed.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ...ops.fr import canonical_device
from ...ops.host.poly import Poly
from ...ops.msm import affine_to_host, msm_context
from ...ops.ntt import ntt_context
from ...ops.polydev import PolyDev
from ...ops.srs import DeviceSRS
from ...rng import Rng
from ...transcript import Transcript
from ...utils.build import count_sync
from ...utils.profiling import span
from ..kzg import KZG
from .indexer import Indexer


class DeviceProver:
    """Marlin prover with device compute: the host Prover's prove()
    contract, transcript and proof dict."""

    def __init__(self, curve_type: str = "bn254", rng: Rng | None = None,
                 collect_timings: bool = False, device="cuda"):
        self.device = canonical_device(device)
        self.kzg = KZG(curve_type=curve_type, backend="cuda", rng=rng,
                       device=self.device)
        self.rng = self.kzg.rng
        self.collect_timings = collect_timings
        self.timings: dict[str, float] = {}

    @property
    def pd(self) -> PolyDev:
        """The polynomial toolkit, looked up at call time (so checked
        while KZG_TPU_CHECKED is on)."""
        return PolyDev(self.kzg.curve_type, self.device)

    @property
    def be(self):
        return self.pd.be

    @contextlib.contextmanager
    def _phase(self, name: str):
        """One phase of the prove, under the span ``marlin.<name>``.  With
        timings on, wait for the device at its close, so the phases add up
        to the wall time, and record its time; with them off, neither."""
        t0 = time.perf_counter()
        with span(f"marlin.{name}"):
            yield
            if self.collect_timings:
                count_sync("marlin.phase")
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        if self.collect_timings:
            self.timings[name] = self.timings.get(name, 0.0) + \
                time.perf_counter() - t0

    def preprocess(self, A, B, C, max_degree: int, tau: int | None = None):
        """The host ``Indexer`` (RNG draws, encoding, ipk / ivk layout) with
        this prover's KZG: the SRS lives on the device and the nine index
        commitments run there."""
        indexer = Indexer(self.kzg.curve_type, rng=self.rng)
        indexer.kzg = self.kzg
        return indexer.preprocess(A, B, C, max_degree, tau=tau)

    def _ntt(self, n: int):
        return ntt_context(self.kzg.curve_type, n, self.device)

    # ------------------------------------------------------------------
    def _commit(self, ck: DeviceSRS, coeffs_mont: torch.Tensor):
        ctx = msm_context(self.kzg.curve_type, self.device)
        be = ctx.scalar_backend
        m = coeffs_mont.shape[1]
        pts = ck.slice_pow2(m)
        canonical = self.pd.pad(be.from_mont(coeffs_mont), pts.shape[-1])
        result = ctx.msm(pts, canonical)
        return affine_to_host(self.kzg, ctx.curve.to_affine_ints(result)[0])

    def _open(self, ck, coeff_list, point: int, xi) -> tuple:
        be, pd = self.be, self.pd
        xi_f = self.kzg.Fq(int(xi))
        max_len = max(c.shape[1] for c in coeff_list)
        acc = torch.zeros((be.num_limbs, max_len), dtype=torch.int32,
                          device=self.device)
        for i, coeffs in enumerate(coeff_list):
            acc = be.add(acc, be.mul(pd.pad(coeffs, max_len),
                                     be.scalar(int(xi_f ** (i + 1)))))
        return self._commit(ck, pd.open_div(acc, point))

    # ------------------------------------------------------------------
    def _device_index(self, ipk) -> dict:
        """Static per-circuit device data, cached inside the ipk."""
        if "_device_cache" in ipk:
            return ipk["_device_cache"]
        be, pd = self.be, self.pd
        n, m = ipk["subgroups"]["n"], ipk["subgroups"]["m"]
        H = ipk["subgroups"]["H"]
        polys = ipk["polynomials"]

        dev: dict = {"n": n, "m": m}
        h_to_idx = {int(h): i for i, h in enumerate(H)}

        big = 8 * m
        ctx_m = self._ntt(m)
        ctx_big = self._ntt(big)
        for name in ("A", "B", "C"):
            for kind in ("row", "col", "val"):
                coeffs = be.from_ints([int(c) for c in
                                       polys[f"{kind}_{name}"].padded(m)])
                dev[f"{kind}{name}_coeffs"] = coeffs
                dev[f"{kind}{name}_K"] = ctx_m.ntt(coeffs)
                dev[f"{kind}{name}_big"] = ctx_big.ntt(pd.pad(coeffs, big))
            # static row grouping: kappa -> H-index (n = dump bin for padding)
            row_ints = be.to_ints(dev[f"row{name}_K"])
            dev[f"rowidx_{name}"] = torch.tensor(
                [h_to_idx.get(v, n) for v in row_ints], dtype=torch.int64,
                device=self.device)

        # sparse matrices as static COO for the device matvec
        for name in ("A", "B", "C"):
            M = ipk[name]
            pos = M.nonzero_positions()
            rows = np.array([i for i, _ in pos], dtype=np.int64)
            cols = np.array([j for _, j in pos], dtype=np.int64)
            vals = be.from_ints([int(M[i, j]) for i, j in pos])
            dev[f"coo_{name}"] = (torch.from_numpy(rows).to(self.device),
                                  torch.from_numpy(cols).to(self.device),
                                  vals)

        ipk["_device_cache"] = dev
        return dev

    def _matvec(self, dev, name, z_vec, nrows):
        """Sparse matvec over the static COO pattern."""
        be, pd = self.be, self.pd
        rows, cols, vals = dev[f"coo_{name}"]
        prods = be.mul(vals, z_vec[:, cols])
        return pd.segment_sum_mod(prods, rows, nrows)

    # ------------------------------------------------------------------
    def prove(self, ipk, x, w, zero_knowledge_bound: int = 2):
        kzg = self.kzg
        Fq = kzg.Fq
        be, pd = self.be, self.pd
        ck = ipk["ck"]
        if not isinstance(ck, DeviceSRS):
            raise TypeError("DeviceProver needs an ipk with a DeviceSRS "
                            "(DeviceProver.preprocess)")
        H = ipk["subgroups"]["H"]
        n, m = ipk["subgroups"]["n"], ipk["subgroups"]["m"]
        sc = lambda v: be.scalar(int(v))                    # noqa: E731
        ctx_n = self._ntt(n)
        ctx_m = self._ntt(m)
        big = 8 * m
        ctx_big = self._ntt(big)

        self.timings = {}
        with self._phase("index_cache"):
            dev = self._device_index(ipk)
        with self._phase("witness_and_matvecs"):
            transcript = Transcript("marlin-proof", Fq)
            transcript.append_message("public-inputs", list(x))

            z_ints = [int(Fq(int(v))) for v in list(x) + list(w)]
            x_size = len(x)

            # v_H_x, v_H_w as host polys (degree x_size / n - x_size).
            v_H_x = Poly(Fq, [1])
            for h in H[:x_size]:
                v_H_x = v_H_x * Poly(Fq, [-h, 1])
            x_points = [(H[i], Fq(z_ints[i])) for i in range(x_size)]
            x_poly_h = Poly.lagrange(Fq, x_points)
            x_dev = be.from_ints([int(c) for c in x_poly_h.padded(x_size)])
            vhx_dev = be.from_ints([int(c)
                                    for c in v_H_x.padded(x_size + 1)])

            # ---- encode witness (reference encoder.py:134-189) on device ----
            z_vec = be.from_ints(z_ints + [0] * (n - len(z_ints)))
            x_on_H = ctx_n.ntt(pd.pad(x_dev, n))
            zero_head = torch.arange(n, device=self.device) < x_size
            values = be.sub(z_vec, x_on_H)
            values = torch.where(zero_head[None], torch.zeros_like(values),
                                 values)
            f = ctx_n.intt(values)
            # w_poly = f / v_H_x via coset pointwise division
            s_coset = pd.shift
            f_cos = ctx_n.coset_ntt(f, s_coset)
            vhx_cos = ctx_n.coset_ntt(pd.pad(vhx_dev, n), s_coset)
            w_poly = ctx_n.coset_intt(
                be.mul(f_cos, be.batch_inv(vhx_cos)),
                s_coset)[:, :n - x_size]

            # ---- linear combinations zA/zB/zC (encoder.py:191-234) ----------
            zA_poly = ctx_n.intt(self._matvec(dev, "A", z_vec, n))
            zB_poly = ctx_n.intt(self._matvec(dev, "B", z_vec, n))
            zC_poly = ctx_n.intt(self._matvec(dev, "C", z_vec, n))
        with self._phase("masks_and_h0"):
            # ---- blinding (reference prover.py:79-102; same draw order) -----
            b = zero_knowledge_bound

            def draw_ints(k):
                return [int(self.rng.random_element(Fq)) for _ in range(k)]

            w_rand = draw_ints(b)
            zA_rand = draw_ints(b)
            zB_rand = draw_ints(b)
            zC_rand = draw_ints(b)

            def mask_vanishing(coeffs, rand_ints, k):
                """coeffs + rand(X) * (X^k - 1)."""
                rand = be.from_ints(rand_ints)
                r = len(rand_ints)
                out = pd.pad(coeffs, max(coeffs.shape[1], k + r))
                lo = be.sub(out[:, :r], rand)
                hi = be.add(out[:, k:k + r], rand)
                return torch.cat([lo, out[:, r:k], hi, out[:, k + r:]],
                                 dim=1)

            # w mask uses v_H_w = v_H / v_H_x (degree n - x_size).
            v_H_w_h = Poly.vanishing(Fq, n) / v_H_x
            vhw_dev = be.from_ints([int(c) for c in
                                    v_H_w_h.padded(n - x_size + 1)])
            w_rand_dev = be.from_ints(w_rand)
            w_masked = be.add(pd.pad(pd.mul(w_rand_dev, vhw_dev), n + b),
                              pd.pad(w_poly, n + b))
            zA_masked = mask_vanishing(zA_poly, zA_rand, n)
            zB_masked = mask_vanishing(zB_poly, zB_rand, n)
            zC_masked = mask_vanishing(zC_poly, zC_rand, n)
            z_masked = be.add(
                pd.pad(pd.mul(w_masked, vhx_dev), n + b + x_size),
                pd.pad(x_dev, n + b + x_size))

            # h_0 = (zA zB - zC) / v_H (reference :96-97).
            prod = pd.mul(zA_masked, zB_masked)
            num = be.sub(prod, pd.pad(zC_masked, prod.shape[1]))
            h_0, _ = pd.divide_by_vanishing(num, n)

            # s with sum over H forced to zero (reference :99-102).
            s_ints = draw_ints(2 * n + b - 1)
            s_sum = sum(s_ints[k] for k in range(0, len(s_ints), n)) * n
            s_ints[0] = (s_ints[0] - (s_sum * pow(n, -1, Fq.modulus))) \
                % Fq.modulus
            s_dev = be.from_ints(s_ints)
        with self._phase("round1_commits"):
            # ---- Round 1 ----------------------------------------------------
            first_round = [w_masked, zA_masked, zB_masked, zC_masked, h_0,
                           s_dev]
            first_round_commitments = [self._commit(ck, c)
                                       for c in first_round]
        with self._phase("t_and_sumcheck1"):
            transcript.append_message("round1-commitments",
                                      first_round_commitments)
            eta_A = transcript.get_challenge("eta_A")
            eta_B = transcript.get_challenge("eta_B")
            eta_C = transcript.get_challenge("eta_C")
            alpha = transcript.get_challenge("alpha")
            while alpha in H:
                alpha = transcript.get_challenge("alpha-retry")

            # ---- t(X) by evaluation over H ---------------------------------
            t_poly = self._t_polynomial(dev, eta_A, eta_B, eta_C, alpha, n,
                                        ctx_n)

            # ---- first sumcheck (reference :127-138) ------------------------
            # u_H(alpha, X) = sum_i alpha^(n-1-i) X^i: reversed powers.
            r_alpha = be.powers_of(int(alpha), n).flip(1)
            combo = be.add(
                be.add(be.mul(pd.pad(zA_masked, n + b), sc(eta_A)),
                       be.mul(pd.pad(zB_masked, n + b), sc(eta_B))),
                be.mul(pd.pad(zC_masked, n + b), sc(eta_C)))
            term = pd.mul(r_alpha, combo)
            t_z = pd.mul(t_poly, z_masked)
            width = max(s_dev.shape[1], term.shape[1], t_z.shape[1])
            poly_1 = be.sub(
                be.add(pd.pad(s_dev, width), pd.pad(term, width)),
                pd.pad(t_z, width))
            h_1, rem = pd.divide_by_vanishing(poly_1, n)
            assert be.to_ints(rem[:, :1])[0] == 0, "Sum over H is not 0"
            g_1 = rem[:, 1:]
        with self._phase("round2_commits"):
            second_round = [t_poly, g_1, h_1]
            second_round_commitments = [self._commit(ck, c)
                                        for c in second_round]
        with self._phase("sumcheck2"):
            transcript.append_message("round2-commitments",
                                      second_round_commitments)
            beta_1 = transcript.get_challenge("beta_1")
            while beta_1 in H:
                beta_1 = transcript.get_challenge("beta_1-retry")

            # ---- second sumcheck over K (reference :154-172) ----------------
            v_H_alpha = Fq(int(alpha)) ** n - 1
            v_H_beta1 = Fq(int(beta_1)) ** n - 1
            scale = v_H_beta1 * v_H_alpha

            # a(X), b(X) on the 8m evaluation domain.
            a_big, b_big = self._ab_evals(dev, eta_A, eta_B, eta_C,
                                          beta_1, alpha, scale)
            a_poly = ctx_big.intt(a_big)[:, :5 * (m - 1) + 1]
            b_poly_full = ctx_big.intt(b_big)[:, :6 * (m - 1) + 1]

            t_beta1 = Fq(pd.eval_int(t_poly, int(beta_1)))

            # f_2 over K (reference :404-471).
            f2_evals = self._f2_evals(dev, eta_A, eta_B, eta_C, beta_1,
                                      alpha, scale)
            f_2 = ctx_m.intt(f2_evals)
            f2_const = Fq(be.to_ints(f_2[:, :1])[0])
            assert f2_const == t_beta1 / Fq(m), "f_2 polynomial is incorrect"

            g_2 = f_2[:, 1:]
            bf2 = pd.mul(b_poly_full, f_2)
            width = max(a_poly.shape[1], bf2.shape[1])
            h2_num = be.sub(pd.pad(a_poly, width), pd.pad(bf2, width))
            h_2, _ = pd.divide_by_vanishing(h2_num, m)
        with self._phase("round3_commits"):
            third_round = [g_2, h_2]
            third_round_commitments = [self._commit(ck, c)
                                       for c in third_round]
        with self._phase("linearization_and_evals"):
            transcript.append_message("round3-commitments",
                                      third_round_commitments)
            beta_2 = transcript.get_challenge("beta_2")

            # ---- linearization (reference :184-201) -------------------------
            zA_b1 = Fq(pd.eval_int(zA_masked, int(beta_1)))
            zB_b1 = Fq(pd.eval_int(zB_masked, int(beta_1)))
            flen = max(zB_masked.shape[1], h_0.shape[1])
            f_1 = be.sub(be.sub(be.mul(pd.pad(zB_masked, flen), sc(zA_b1)),
                                pd.pad(zC_masked, flen)),
                         be.mul(pd.pad(h_0, flen), sc(v_H_beta1)))

            x_b1 = x_poly_h(beta_1)
            vhx_b1 = Fq(1)
            for h in H[:x_size]:
                vhx_b1 = vhx_b1 * (beta_1 - h)
            r_ab1 = (alpha ** n - beta_1 ** n) / (alpha - beta_1)

            wlen = max(s_dev.shape[1], w_masked.shape[1],
                       zB_masked.shape[1], h_1.shape[1],
                       g_1.shape[1] if g_1.shape[1] else 1)
            z_lin = be.add(be.mul(pd.pad(w_masked, wlen), sc(vhx_b1)),
                           self._const_poly(int(x_b1), wlen))
            f_2_lin = pd.pad(s_dev, wlen)
            eta_combo = be.add(be.mul(pd.pad(zB_masked, wlen), sc(eta_B)),
                               be.mul(pd.pad(zC_masked, wlen), sc(eta_C)))
            eta_combo = be.add(eta_combo,
                               self._const_poly(int(eta_A * zA_b1), wlen))
            f_2_lin = be.add(f_2_lin, be.mul(eta_combo, sc(r_ab1)))
            f_2_lin = be.sub(f_2_lin, be.mul(z_lin, sc(t_beta1)))
            f_2_lin = be.sub(f_2_lin,
                             be.mul(pd.pad(h_1, wlen), sc(v_H_beta1)))
            f_2_lin = be.sub(f_2_lin, be.mul(pd.pad(g_1, wlen), sc(beta_1)))

            # f_3 = h_2 v_K(beta_2) - a_lin + b_lin (beta_2 g_2 + t_beta1/m)
            a_lin, b_lin = self._ab_linear(dev, eta_A, eta_B, eta_C, beta_1,
                                           beta_2, alpha, scale)
            v_K_b2 = Fq(int(beta_2)) ** m - 1
            flen = max(h_2.shape[1], a_lin.shape[1], g_2.shape[1])
            f_3 = be.sub(be.mul(pd.pad(h_2, flen), sc(v_K_b2)),
                         pd.pad(a_lin, flen))
            tail = be.add(be.mul(pd.pad(g_2, flen), sc(beta_2)),
                          self._const_poly(int(t_beta1 / Fq(m)), flen))
            f_3 = be.add(f_3, be.mul(tail, sc(b_lin)))

            # ---- evaluations + openings (reference :204-227) ----------------
            evals_beta1 = [zA_b1, Fq(pd.eval_int(t_poly, int(beta_1)))]
            polys_beta2_dev = [dev[f"{kind}{name}_coeffs"]
                               for name in ("A", "B", "C")
                               for kind in ("row", "col")]
            evals_beta2 = [Fq(pd.eval_int(p, int(beta_2)))
                           for p in polys_beta2_dev]

            transcript.append_message("evaluations-beta1", evals_beta1)
            transcript.append_message("evaluations-beta2", evals_beta2)
            xi_1 = transcript.get_challenge("xi_1")
            xi_2 = transcript.get_challenge("xi_2")
        with self._phase("openings"):
            proof_beta1 = self._open(ck, [f_1, f_2_lin, zA_masked, t_poly],
                                     int(beta_1), xi_1)
            proof_beta2 = self._open(ck, [f_3] + polys_beta2_dev,
                                     int(beta_2), xi_2)

        return {
            "commitments": {
                "first_round": first_round_commitments,
                "second_round": second_round_commitments,
                "third_round": third_round_commitments,
            },
            "evaluations": {"beta1": evals_beta1, "beta2": evals_beta2},
            "kzg_proofs": {"beta1": proof_beta1, "beta2": proof_beta2},
        }

    # ------------------------------------------------------------------
    def _const_poly(self, c: int, width: int) -> torch.Tensor:
        return self.pd.pad(self.be.scalar(c), width)

    def _t_polynomial(self, dev, eta_A, eta_B, eta_C, alpha, n, ctx_n):
        """t evals over H: t(h) = n h^-1 v_H(alpha) *
        sum_{kappa: row(kappa)=h} eta_M val_M(kappa)/(alpha - col_M(kappa));
        zero-val padding lands in the dump bin n."""
        be, pd = self.be, self.pd
        Fq = self.kzg.Fq
        v_H_alpha = Fq(int(alpha)) ** n - 1
        bins = None
        for name, eta in (("A", eta_A), ("B", eta_B), ("C", eta_C)):
            denom = be.sub(be.scalar(int(alpha)), dev[f"col{name}_K"])
            u = be.mul(be.mul(dev[f"val{name}_K"], be.batch_inv(denom)),
                       be.scalar(int(eta)))
            part = pd.segment_sum_mod(u, dev[f"rowidx_{name}"], n + 1)[:, :n]
            bins = part if bins is None else be.add(bins, part)
        h_inv = be.powers_of(pow(int(ctx_n.root), -1, Fq.modulus), n)
        t_evals = be.mul(be.mul(bins, h_inv),
                         be.scalar(int(Fq(n) * v_H_alpha)))
        return ctx_n.intt(t_evals)

    def _ab_evals(self, dev, eta_A, eta_B, eta_C, beta_1, alpha, scale):
        """a(X), b(X) evaluations on the size-8m plain domain."""
        be = self.be
        sc = lambda v: be.scalar(int(v))                    # noqa: E731
        names = ("A", "B", "C")
        etas = {"A": eta_A, "B": eta_B, "C": eta_C}
        pair = {}
        for name in names:
            br = be.sub(sc(beta_1), dev[f"row{name}_big"])
            ac = be.sub(sc(alpha), dev[f"col{name}_big"])
            pair[name] = be.mul(br, ac)
        a_evals = None
        for name in names:
            other = be.mul(*[pair[o] for o in names if o != name])
            term = be.mul(be.mul(dev[f"val{name}_big"], other),
                          sc(etas[name] * scale))
            a_evals = term if a_evals is None else be.add(a_evals, term)
        b_evals = be.mul(be.mul(pair["A"], pair["B"]), pair["C"])
        return a_evals, b_evals

    def _f2_evals(self, dev, eta_A, eta_B, eta_C, beta_1, alpha, scale):
        be = self.be
        sc = lambda v: be.scalar(int(v))                    # noqa: E731
        total = None
        for name, eta in (("A", eta_A), ("B", eta_B), ("C", eta_C)):
            denom = be.mul(be.sub(sc(beta_1), dev[f"row{name}_K"]),
                           be.sub(sc(alpha), dev[f"col{name}_K"]))
            term = be.mul(be.mul(dev[f"val{name}_K"], be.batch_inv(denom)),
                          sc(eta * scale))
            total = term if total is None else be.add(total, term)
        return total

    def _ab_linear(self, dev, eta_A, eta_B, eta_C, beta_1, beta_2, alpha,
                   scale):
        """Linearized a(X) (val stays polynomial) + scalar b at beta_2
        (reference :355-402)."""
        be, pd = self.be, self.pd
        Fq = self.kzg.Fq
        names = ("A", "B", "C")
        etas = {"A": eta_A, "B": eta_B, "C": eta_C}
        evals = {}
        for name in names:
            evals[f"row_{name}"] = Fq(pd.eval_int(dev[f"row{name}_coeffs"],
                                                  int(beta_2)))
            evals[f"col_{name}"] = Fq(pd.eval_int(dev[f"col{name}_coeffs"],
                                                  int(beta_2)))
        a = None
        b = Fq(1)
        for name in names:
            other = Fq(1)
            for o in names:
                if o != name:
                    other = other * ((beta_1 - evals[f"row_{o}"])
                                     * (alpha - evals[f"col_{o}"]))
            term = be.mul(dev[f"val{name}_coeffs"],
                          be.scalar(int(etas[name] * scale * other)))
            a = term if a is None else be.add(a, term)
            b = b * ((beta_1 - evals[f"row_{name}"])
                     * (alpha - evals[f"col_{name}"]))
        return a, b
