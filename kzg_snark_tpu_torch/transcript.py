"""Fiat-Shamir transcript with byte-exact reference serialization.

Behavioral mirror of ``transcript.py``:

* state chaining: ``state = SHA256(label)`` then
  ``state = SHA256(state || label || data)`` per message (reference :23, :96-100),
* ``get_challenge``: ``c_bytes = SHA256(state || label)``, challenge =
  int(c_bytes, big-endian) reduced into the field, then the state absorbs the
  raw 32 challenge bytes (reference :47-54),
* serialization rules (reference :58-85):
    - str   -> utf-8 bytes
    - int   -> 8-byte big-endian (struct '>q')
    - bytes -> unchanged
    - list  -> concatenation of element serializations (no separators)
    - field elements (Sage GF elements in the reference) -> ``str()`` =
      canonical decimal integer
    - curve points (py_ecc tuples of FQ in the reference) -> ``str()`` of the
      projective tuple, e.g. ``"(1, 2, 1)"``; py_ecc's FQ prints as a bare
      int, so tuples of our host field elements print identically.

Because the reference hashes *non-normalized projective coordinates*, full
bit-exactness requires the compat curve path (``ops.host.curve``) whose
formulas reproduce py_ecc's representatives.  The device path normalizes
commitments to a canonical projective representative (affine (x, y, 1) /
identity (1, 1, 0)) before transcript absorption; prover and verifier then
agree with each other, which is what soundness needs — see
``models/kzg.py`` for the mode switch.
"""

from __future__ import annotations

import hashlib
import struct


class Transcript:
    def __init__(self, label: str, field):
        """``field`` is the scalar-field element class (host Fr)."""
        self.label = label
        self.F = field
        self.state = hashlib.sha256(label.encode()).digest()

    def append_message(self, message_label: str, message_data) -> None:
        self._update_state(message_label, self._serialize(message_data))

    def get_challenge(self, label: str):
        challenge_state = hashlib.sha256(self.state + label.encode()).digest()
        challenge_int = int.from_bytes(challenge_state, byteorder="big")
        challenge = self.F(challenge_int)
        self._update_state(label, challenge_state)
        return challenge

    def _serialize(self, data) -> bytes:
        if isinstance(data, str):
            return data.encode()
        if isinstance(data, bool):
            # bools are ints in Python; match reference behavior (struct '>q')
            return struct.pack(">q", int(data))
        if isinstance(data, int):
            return struct.pack(">q", data)
        if isinstance(data, bytes):
            return data
        if isinstance(data, list):
            result = b""
            for item in data:
                result += self._serialize(item)
            return result
        # Field elements, curve-point tuples, and anything else: str().
        # (Reference: Sage objects and the default fallback both stringify.)
        return str(data).encode()

    def _update_state(self, label: str, data: bytes) -> None:
        hasher = hashlib.sha256()
        hasher.update(self.state)
        hasher.update(label.encode())
        hasher.update(data)
        self.state = hasher.digest()
