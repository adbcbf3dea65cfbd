"""Limb layout of the port and the per-modulus constants its kernels take.

A batch of field elements is an ``(8, n)`` ``torch.int32`` tensor: limb k of
element i holds the bit pattern of the k-th 32-bit limb (least significant
first), limb-major so neighbouring threads read neighbouring words.  Values
are canonical (< p) and, for arithmetic, in Montgomery form with R = 2^256:
the same integers as the JAX package's ``(16, n)`` 16-bit-limb arrays.

The conversions here are numpy-vectorized (one bytes buffer per batch), so
they cost milliseconds at 2^18 elements.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

NUM_LIMBS = 8
LIMB_BITS = 32
R_BITS = NUM_LIMBS * LIMB_BITS


def ints_to_words(values) -> np.ndarray:
    """Non-negative ints < 2^256 -> (8, N) uint32 limb matrix."""
    values = list(values)
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    mat = np.frombuffer(buf, dtype="<u4").reshape(len(values), NUM_LIMBS)
    return mat.T.copy()


def words_to_ints(words: np.ndarray) -> list[int]:
    """(8, N) uint32 limb matrix -> list of ints."""
    flat = np.ascontiguousarray(words.reshape(NUM_LIMBS, -1).T, dtype="<u4")
    buf = flat.tobytes()
    return [int.from_bytes(buf[32 * j:32 * j + 32], "little")
            for j in range(flat.shape[0])]


def to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 limb matrix -> int32 tensor (same bits) on ``device``."""
    arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def to_words(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy array with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


class FieldConsts:
    """Constants of one prime modulus p < 2^254.

    ``ptr`` addresses the 17-word block the C entry points copy into their
    ``FieldConsts`` struct (p, R mod p, -p^-1 mod 2^32); the plain versions
    take the same values as tensors from :meth:`tensors`.
    """

    _CACHE: dict[int, "FieldConsts"] = {}

    def __new__(cls, modulus: int):
        if modulus in cls._CACHE:
            return cls._CACHE[modulus]
        self = super().__new__(cls)
        cls._CACHE[modulus] = self
        self._init(modulus)
        return self

    def _init(self, modulus: int) -> None:
        if modulus.bit_length() > R_BITS - 2:
            raise ValueError("modulus must be below 2^254")
        self.modulus = modulus
        self.R = 1 << R_BITS
        self.one_mont = self.R % modulus
        self.r2 = (self.R * self.R) % modulus
        self.pinv32 = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
        self.n0_16 = (-pow(modulus, -1, 1 << 16)) % (1 << 16)
        words = [int(w) for w in ints_to_words([modulus, self.one_mont])
                 .T.reshape(-1)] + [self.pinv32]
        self._block = (ctypes.c_uint32 * len(words))(*words)
        self.ptr = ctypes.addressof(self._block)
        self._tensors: dict[str, dict[str, torch.Tensor]] = {}

    def tensors(self, device) -> dict[str, torch.Tensor]:
        """p as (8, 1) 32-bit and (16, 1) 16-bit int64 limb columns, and
        Montgomery one as an (8, 1) int32 column, on ``device``."""
        key = str(torch.device(device))
        if key not in self._tensors:
            p_words = ints_to_words([self.modulus]).astype(np.int64)
            p16 = np.stack([p_words & 0xFFFF, p_words >> 16], axis=1)
            self._tensors[key] = {
                "p32": torch.from_numpy(p_words).to(device),
                "p16": torch.from_numpy(p16.reshape(16, 1)).to(device),
                "one": to_tensor(ints_to_words([self.one_mont]), device),
            }
        return self._tensors[key]
