"""ctypes loader for the native BN254 pairing library (csrc/bn254_pairing.cpp).

The port's copy of the JAX package's ``utils/native.py``: it builds the
package's own copy of the source into ``.build/torch_pairing/``.

Builds the shared library on first use (g++ is in the image; no pybind11
needed — plain C ABI + ctypes).  Falls back silently to the pure-Python
tower (ops/host/pairing.py) if compilation fails; callers check
``available()``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from .. import constants as C

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "bn254_pairing.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), ".build", "torch_pairing")
_LIB = os.path.join(_BUILD_DIR, "libbn254.so")

_lock = threading.Lock()
_lib = None
_load_failed = False


def _hard_exp_words():
    p = C.BN254_P
    hard = (p ** 4 - p ** 2 + 1) // C.BN254_R
    words = []
    while hard:
        words.append(hard & 0xFFFFFFFFFFFFFFFF)
        hard >>= 64
    return words


def _build() -> bool:
    """Build into a temporary name and rename, so that processes building
    side by side never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.tmp{os.getpid()}"
    try:
        subprocess.run(
            ["g++", "-O2", "-fPIC", "-shared", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except Exception:
        return False


def get_lib():
    """The loaded+initialized library, or None if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not os.path.exists(_LIB) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)):
            if not _build():
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB)
            words = _hard_exp_words()
            arr = (ctypes.c_uint64 * len(words))(*words)
            lib.bn254_init(arr, len(words))
            lib.bn254_pairing.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                          ctypes.c_char_p]
            lib.bn254_pairing_eq.argtypes = [ctypes.c_char_p] * 4
            lib.bn254_pairing_eq.restype = ctypes.c_int
            _lib = lib
        except Exception:
            _load_failed = True
        return _lib


def available() -> bool:
    return get_lib() is not None


def _g1_bytes(pt_affine) -> bytes:
    """(x, y) ints or None -> 64 bytes big-endian (zeros = identity)."""
    if pt_affine is None:
        return b"\x00" * 64
    x, y = pt_affine
    return int(x).to_bytes(32, "big") + int(y).to_bytes(32, "big")


def _g2_bytes(pt_affine) -> bytes:
    """((x0,x1),(y0,y1)) Fq2 ints or None -> 128 bytes."""
    if pt_affine is None:
        return b"\x00" * 128
    (x0, x1), (y0, y1) = pt_affine
    return (int(x0).to_bytes(32, "big") + int(x1).to_bytes(32, "big")
            + int(y0).to_bytes(32, "big") + int(y1).to_bytes(32, "big"))


def pairing_bytes(g2_affine, g1_affine) -> bytes:
    """e(Q, P) as 12*32 canonical bytes (tower coefficient order)."""
    lib = get_lib()
    out = ctypes.create_string_buffer(384)
    lib.bn254_pairing(_g2_bytes(g2_affine), _g1_bytes(g1_affine), out)
    return out.raw


def pairing_eq(a2_affine, a1_affine, b2_affine, b1_affine) -> bool:
    """e(A2, A1) == e(B2, B1) via the native library."""
    lib = get_lib()
    return bool(lib.bn254_pairing_eq(
        _g2_bytes(a2_affine), _g1_bytes(a1_affine),
        _g2_bytes(b2_affine), _g1_bytes(b1_affine)))
