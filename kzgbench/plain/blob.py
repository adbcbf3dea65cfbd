"""Expected answers of the ``blob`` protocol (EIP-4844), plain."""

from __future__ import annotations

import numpy as np

from .curves import compress
from .reference import Reference, words_to_limbs16
from .transcript import blob_challenge, field_bytes


def expected(ref: Reference, words: np.ndarray) -> dict:
    """Blobs (8, k, n) canonical words -> {"commitments", "evaluations",
    "proofs"}: per blob, the specs' ``blob_to_kzg_commitment``, the value
    at ``compute_challenge`` and ``compute_blob_kzg_proof``."""
    curve, n = ref.curve, ref.n
    v16 = words_to_limbs16(words)                       # (k, n, 16)
    at_tau = ref.at_tau(v16)
    commitments = [ref.g.mul(t) for t in at_tau]
    evaluations, proofs = [], []
    for i, C in enumerate(commitments):
        z = blob_challenge(field_bytes(words[:, i, :]), compress(C, curve),
                           n, curve.r)
        y = ref.evaluate(v16[i], z)[0]
        evaluations.append(y)
        proofs.append(ref.g.mul(ref.quotient(at_tau[i], y, z)))
    return {"commitments": commitments, "evaluations": evaluations,
            "proofs": proofs}
