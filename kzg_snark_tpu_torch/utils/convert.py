"""State carried across from the JAX package, as numpy arrays and ints.

The JAX package holds field elements as (2 L, ...) uint32 arrays of 16-bit
limbs; the port as (L, ...) int32 tensors of 32-bit limbs: L = 8 (the JAX
package's 16) for both curves' Fr and BN254 Fq, L = 12 (24) for BLS12-381
Fq.  Both are the same Montgomery integers (R = 2^256 or 2^384), so
conversion is a pairing of limbs, no arithmetic.  Nothing here imports JAX:
callers pass ``np.asarray`` of JAX arrays.

The two packages' host field classes are distinct (the port keeps its own
copy of the host layer), so their elements never compare equal to each
other; ``to_plain`` maps proofs, keys and points of either to ints.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.limbs import to_tensor, to_words


def limbs16_to_tensor(arr, device="cuda") -> torch.Tensor:
    """(2 L, ...) uint32 16-bit limbs -> (L, ...) int32 32-bit limbs, L = 8
    or 12."""
    a = np.asarray(arr, dtype=np.uint32)
    if a.shape[0] not in (16, 24) or (a >> 16).any():
        raise ValueError("expected (16, ...) or (24, ...) 16-bit limbs")
    words = a[0::2] | (a[1::2] << np.uint32(16))
    return to_tensor(words, device)


def tensor_to_limbs16(t: torch.Tensor) -> np.ndarray:
    """(L, ...) int32 32-bit limbs -> (2 L, ...) uint32 16-bit limbs."""
    w = to_words(t)
    out = np.empty((2 * w.shape[0],) + w.shape[1:], dtype=np.uint32)
    out[0::2] = w & np.uint32(0xFFFF)
    out[1::2] = w >> np.uint32(16)
    return out


def points16_to_tensor(pts, device="cuda") -> torch.Tensor:
    """(3, 2 L, ...) JAX Jacobian points -> (3, L, ...) port points."""
    a = np.asarray(pts, dtype=np.uint32)
    return torch.stack([limbs16_to_tensor(a[i], device) for i in range(3)])


def device_srs_from_jax(curve_type: str, points, device="cuda"):
    """A JAX ``DeviceSRS.points`` (3, 2 L, d+1) array -> port DeviceSRS."""
    from ..ops.srs import DeviceSRS
    return DeviceSRS(curve_type, points16_to_tensor(points, device))


def device_cache_from_jax(cache: dict, device="cuda") -> dict:
    """A JAX ``ipk["_device_cache"]`` dict of (16, n) Fr arrays -> the
    port's dict of (8, n) tensors, under the same keys."""
    return {k: limbs16_to_tensor(v, device) for k, v in cache.items()}


def to_plain(obj):
    """Host field elements (prime field: ``.n``; tower: ``.c0``, ``.c1``
    ...) -> ints and tuples of ints, through tuples, lists and dicts."""
    if isinstance(obj, dict):
        return {k: to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return tuple(to_plain(v) for v in obj)
    if hasattr(obj, "n") and isinstance(obj.n, int):
        return obj.n
    slots = [a for a in ("c0", "c1", "c2") if hasattr(obj, a)]
    if slots:
        return tuple(to_plain(getattr(obj, a)) for a in slots)
    return obj
