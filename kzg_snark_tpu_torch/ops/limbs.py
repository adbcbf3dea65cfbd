"""Limb layout of the port and the per-modulus constants its kernels take.

A batch of field elements is an ``(L, n)`` ``torch.int32`` tensor of L
32-bit limbs: limb k of element i holds the bit pattern of the k-th limb
(least significant first), limb-major so neighbouring threads read
neighbouring words.  L follows the modulus (``limbs_for``): 8 words for
BN254 Fr and Fq and BLS12-381 Fr (R = 2^256), 12 for BLS12-381 Fq (R =
2^384).  Values are canonical (< p) and, for arithmetic, in Montgomery form
with R = 2^(32 L): the same integers as the JAX package's ``(16, n)`` and
``(24, n)`` 16-bit-limb arrays.

The conversions here are numpy-vectorized (one bytes buffer per batch), so
they cost milliseconds at 2^18 elements.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.build import count_sync
from ..utils.profiling import span

LIMB_BITS = 32
LIMB_COUNTS = (8, 12)       # the widths the kernels are instantiated at
SCALAR_LIMBS = 8            # Fr of both curves (at most 255 bits)


def limbs_for(modulus: int) -> int:
    """The fewest instantiated limb counts L with p < 2^(32 L - 1): the
    kernels' sum of two elements must not carry out of L words."""
    for count in LIMB_COUNTS:
        if modulus.bit_length() < LIMB_BITS * count:
            return count
    raise ValueError(f"modulus of {modulus.bit_length()} bits is wider than "
                     f"{LIMB_BITS * LIMB_COUNTS[-1] - 1}")


def ints_to_words(values, num_limbs: int = SCALAR_LIMBS) -> np.ndarray:
    """Non-negative ints < 2^(32 L) -> (L, N) uint32 limb matrix."""
    values = list(values)
    nbytes = 4 * num_limbs
    buf = b"".join(int(v).to_bytes(nbytes, "little") for v in values)
    mat = np.frombuffer(buf, dtype="<u4").reshape(len(values), num_limbs)
    return mat.T.copy()


def words_to_ints(words: np.ndarray) -> list[int]:
    """(L, ...) uint32 limb matrix -> list of ints."""
    num_limbs = words.shape[0]
    flat = np.ascontiguousarray(words.reshape(num_limbs, -1).T, dtype="<u4")
    buf = flat.tobytes()
    nbytes = 4 * num_limbs
    return [int.from_bytes(buf[nbytes * j:nbytes * (j + 1)], "little")
            for j in range(flat.shape[0])]


def to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 limb matrix -> int32 tensor (same bits) on ``device``; to a
    card, a blocking copy."""
    with span("fr.to_device"):
        arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
        count_sync("limbs.to_tensor")
        return torch.from_numpy(arr.copy()).to(device)


def to_words(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy array with the same bits: the host
    waits for the tensor."""
    with span("fr.to_host"):
        count_sync("limbs.to_words")
        return t.detach().cpu().contiguous().numpy().view(np.uint32)


class FieldConsts:
    """Constants of one prime modulus p < 2^(32 L - 1), L = ``num_limbs``.

    ``ptr`` addresses the block the C entry points read (csrc/field.cuh
    ``consts_of``): the limb count L, then p, R mod p and -p^-1 mod 2^32
    (2 L + 2 words); the entry points choose the kernel of width L by it.
    The plain versions take the same values as tensors from
    :meth:`tensors`.
    """

    _CACHE: dict[int, "FieldConsts"] = {}

    def __new__(cls, modulus: int):
        if modulus in cls._CACHE:
            return cls._CACHE[modulus]
        self = super().__new__(cls)
        self._init(modulus)
        cls._CACHE[modulus] = self
        return self

    def _init(self, modulus: int) -> None:
        self.num_limbs = limbs_for(modulus)
        self.modulus = modulus
        self.R = 1 << (LIMB_BITS * self.num_limbs)
        self.one_mont = self.R % modulus
        self.r_inv = pow(self.R, -1, modulus)
        self.r2 = (self.R * self.R) % modulus
        self.pinv32 = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
        self.n0_16 = (-pow(modulus, -1, 1 << 16)) % (1 << 16)
        words = [self.num_limbs] + [
            int(w) for w in ints_to_words([modulus, self.one_mont],
                                          self.num_limbs).T.reshape(-1)
        ] + [self.pinv32]
        self._block = (ctypes.c_uint32 * len(words))(*words)
        self.ptr = ctypes.addressof(self._block)
        self._tensors: dict[str, dict[str, torch.Tensor]] = {}

    def tensors(self, device) -> dict[str, torch.Tensor]:
        """p as (L, 1) 32-bit and (2 L, 1) 16-bit int64 limb columns, and
        Montgomery one as an (L, 1) int32 column, on ``device``."""
        key = str(torch.device(device))
        if key not in self._tensors:
            L = self.num_limbs
            p_words = ints_to_words([self.modulus], L).astype(np.int64)
            p16 = np.stack([p_words & 0xFFFF, p_words >> 16], axis=1)
            self._tensors[key] = {
                "p32": torch.from_numpy(p_words).to(device),
                "p16": torch.from_numpy(p16.reshape(2 * L, 1)).to(device),
                "one": to_tensor(ints_to_words([self.one_mont], L), device),
            }
        return self._tensors[key]
