"""The benchmark's Fiat-Shamir and byte encodings, on Python integers.

Both sides take their challenges from here: the harness on the host in the
timed path (the host protocol layer), and the reference after the window.
The blob challenge is the consensus specs' ``compute_challenge``
(deneb/polynomial-commitments.md); the multi-polynomial challenge and
combiner are this benchmark's own transcript over the commitments.  The
trapdoor tau comes from the seed too, since no ceremony's points are in the
repository.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .curves import Curve, compress

BLOB_DOMAIN = b"FSBLOBVERIFY_V1_"
MULTI_OPEN_DOMAIN = b"KZGBENCH_MULTI_OPEN_V1"
TAU_DOMAIN = b"KZGBENCH_TAU_V1"


def hash_to_field(data: bytes, r: int) -> int:
    """The specs' ``hash_to_bls_field``: SHA-256, big-endian, mod r."""
    return int.from_bytes(hashlib.sha256(data).digest(), "big") % r


def tau_from_seed(seed: int, r: int) -> int:
    """The SRS trapdoor of a run: nonzero mod r, fixed by the seed."""
    counter = 0
    while True:
        tau = hash_to_field(TAU_DOMAIN + (seed % 2 ** 64).to_bytes(8, "big")
                            + counter.to_bytes(4, "big"), r)
        if tau:
            return tau
        counter += 1


def field_bytes(words: np.ndarray) -> bytes:
    """Canonical Fr elements as (8, m) little-endian uint32 words -> the
    specs' encoding: 32 bytes big-endian an element, in column order."""
    le = np.ascontiguousarray(np.asarray(words, dtype=np.uint32).T)
    return le.view(np.uint8).reshape(-1, 32)[:, ::-1].tobytes()


def blob_challenge(blob: bytes, commitment: bytes, n: int, r: int) -> int:
    """``compute_challenge(blob, commitment)`` of the specs."""
    return hash_to_field(BLOB_DOMAIN + n.to_bytes(16, "big") + blob
                         + commitment, r)


def multi_open_challenges(commitments: list, n: int, curve: Curve
                          ) -> tuple[int, int]:
    """(z, xi) of one batch of k polynomials of n coefficients: z over the
    commitments' compressed encodings, xi over z."""
    data = (MULTI_OPEN_DOMAIN + n.to_bytes(16, "big")
            + len(commitments).to_bytes(16, "big")
            + b"".join(compress(c, curve) for c in commitments))
    z = hash_to_field(data + b"z", curve.r)
    xi = hash_to_field(MULTI_OPEN_DOMAIN + z.to_bytes(32, "big") + b"xi",
                       curve.r)
    return z, xi
