"""Expected answers of the ``multi_open`` protocol, plain."""

from __future__ import annotations

import numpy as np

from .reference import Reference, words_to_limbs16
from .transcript import multi_open_challenges


def expected(ref: Reference, words: np.ndarray) -> dict:
    """Polynomials (8, k, n) -> their commitments, their values at the
    batch's challenge z and the one proof of all k at z, combined by
    xi^(i+1) (KZG10's batched opening at one point, as PLONK takes it)."""
    curve, r = ref.curve, ref.curve.r
    v16 = words_to_limbs16(words)
    at_tau = ref.at_tau(v16)
    commitments = [ref.g.mul(t) for t in at_tau]
    z, xi = multi_open_challenges(commitments, ref.n, curve)
    evaluations = ref.evaluate(v16, z)
    combined, power = 0, 1
    for t, y in zip(at_tau, evaluations):
        power = power * xi % r
        combined = (combined + power * ref.quotient(t, y, z)) % r
    return {"commitments": commitments, "evaluations": evaluations,
            "proofs": [ref.g.mul(combined)]}
