"""Batched commit-and-open of k polynomials at one point through the port:
the shape of a PLONK prover's ``_commit_many`` and batched ``_open``.

A batch: the k iNTTs; one k-set MSM over the n SRS points for the
commitments; on the host, the challenge z and the combiner xi over the
commitments; the k evaluations at z (``eval_dev``); the combined
polynomial sum_i xi^(i+1) p_i (``combine_weighted``) and its witness at z
(``open_dev``); one MSM over n - 1 points for the proof.
"""

from __future__ import annotations

import torch

from ..plain.curves import compress
from ..plain.transcript import multi_open_challenges
from .common import PortCell


class Cell(PortCell):
    def msm_calls(self) -> list:
        return [(self.n, self.batch), (self.n - 1, 1)]

    def run_batch(self, slot: int) -> dict:
        be, core, k, curve = self.be, self.core, self.batch, self.curve
        coeffs = self.coefficients(slot)
        commitments = self.commit(coeffs, k, "commit.polys")
        with self.span("host.challenge"):
            z, xi = multi_open_challenges(commitments, self.n, curve)
        with self.span("open"):
            zd = be.scalar(z)
            ys = [core.eval_dev(coeffs[:, i], zd) for i in range(k)]
            weights = be.from_ints([pow(xi, i + 1, curve.r)
                                    for i in range(k)])
            combined = core.combine_weighted(
                [coeffs[:, i] for i in range(k)],
                [weights[:, i:i + 1] for i in range(k)])
            witness = core.open_dev(combined, zd)           # (8, n - 1)
        proofs = self.commit(witness[:, None, :], 1, "commit.proofs")
        with self.span("host.results"):
            evaluations = be.to_ints(torch.cat(ys, dim=1))
            encoded = [compress(P, curve) for P in proofs]
        return {"commitments": commitments, "evaluations": evaluations,
                "proofs": proofs, "proof_bytes": encoded}
