"""Seedable randomness for every protocol sampling site.

The reference samples randomness at these sites (SURVEY.md §2.2):
  * KZG setup tau                      (kzg.py:67)
  * batch_check r when not supplied    (kzg.py:236-237)
  * Marlin blinding w/zA/zB/zC/s       (marlin/prover.py:83-102)
  * PLONK blinding b1..b11             (plonk/prover.py:72-75,346)
  * PLONK coset multipliers k1, k2     (plonk/encoder.py:82-97)

All of them go through :class:`Rng` here so proofs are reproducible given a
seed (golden-vector tests) while defaulting to OS entropy in production.
"""

from __future__ import annotations

import hashlib
import os


class Rng:
    """SHA-256 counter-mode DRBG over a seed; uniform field sampling by
    wide reduction (512 bits mod q, bias < 2^-256)."""

    def __init__(self, seed: int | bytes | None = None):
        if seed is None:
            self._key = os.urandom(32)
        elif isinstance(seed, int):
            self._key = seed.to_bytes(32, "big", signed=False)
        else:
            self._key = hashlib.sha256(seed).digest()
        self._counter = 0

    def _next_bytes(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += hashlib.sha256(
                self._key + self._counter.to_bytes(8, "big")
            ).digest()
            self._counter += 1
        return out[:n]

    def random_int(self, bound: int) -> int:
        """Uniform int in [0, bound)."""
        raw = int.from_bytes(self._next_bytes(64), "big")
        return raw % bound

    def random_element(self, field):
        """Uniform element of a host field class (Sage
        ``Fq.random_element()`` analog)."""
        return field(self.random_int(field.modulus))

    def fork(self, label: str) -> "Rng":
        """Independent child stream (for parallel deterministic sampling)."""
        child = Rng(hashlib.sha256(self._key + label.encode()).digest())
        return child


DEFAULT_RNG = Rng()
