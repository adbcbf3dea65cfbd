"""EIP-4844 blobs through the port (``blob_to_kzg_commitment`` and
``compute_blob_kzg_proof`` for a batch of blobs).

A batch: the iNTT of every blob (values at the domain's points, natural
order) to coefficients; one k-set MSM over the n SRS points for the
commitments; on the host, each blob's challenge over its bytes and its
compressed commitment (the specs' ``compute_challenge``); each blob's
evaluation and witness at its challenge (``PlonkDeviceCore.eval_dev`` and
``open_dev``, one blob a call); one k-set MSM over n - 1 points for the
proofs.
"""

from __future__ import annotations

import torch

from ..plain.curves import compress
from ..plain.transcript import blob_challenge, field_bytes
from .common import PortCell


class Cell(PortCell):
    def __init__(self, *args):
        super().__init__(*args)
        # The blobs as bytes on the host, as a node receives them.
        self.blob_bytes = []
        for slot in range(len(self.pool)):
            words = self.pool_words(slot)
            self.blob_bytes.append([field_bytes(words[:, i, :])
                                    for i in range(self.batch)])

    def msm_calls(self) -> list:
        return [(self.n, self.batch), (self.n - 1, self.batch)]

    def run_batch(self, slot: int) -> dict:
        be, core, k, curve = self.be, self.core, self.batch, self.curve
        coeffs = self.coefficients(slot)
        commitments = self.commit(coeffs, k, "commit.polys")
        with self.span("host.challenge"):
            blobs = self.blob_bytes[slot]
            zs = [blob_challenge(blobs[i], compress(commitments[i], curve),
                                 self.n, curve.r) for i in range(k)]
        with self.span("open"):
            zd = be.from_ints(zs)                           # (8, k)
            ys, ws = [], []
            for i in range(k):
                z = zd[:, i:i + 1]
                ys.append(core.eval_dev(coeffs[:, i], z))
                ws.append(core.open_dev(coeffs[:, i], z))
            witnesses = torch.stack(ws, dim=1)              # (8, k, n - 1)
        proofs = self.commit(witnesses, k, "commit.proofs")
        with self.span("host.results"):
            evaluations = be.to_ints(torch.cat(ys, dim=1))
            encoded = [compress(P, curve) for P in proofs]
        return {"commitments": commitments, "evaluations": evaluations,
                "proofs": proofs, "proof_bytes": encoded}
