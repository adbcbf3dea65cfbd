"""Builds and loads the port's hand-written kernels.

``cuda_lib()`` compiles every ``kzg_snark_tpu_torch/csrc/*.cu`` in one
``nvcc`` call into ``.build/torch_kernels/<hash>/libkzg_torch.so`` (plain C
entry points, loaded with ctypes) the first time a kernel is launched.  The
hash covers the sources and the flags, so an edited source builds anew.  An
``fcntl`` lock lets several processes (pytest workers) share one build.
There is no fallback: without ``nvcc`` or with a failing build it raises.

``host_lib()`` compiles ``csrc/host_check.cpp`` with g++: the kernels'
thread bodies on the CPU, which the tests compare with the plain versions.

Every kernel wrapper calls :func:`count_launch` where it launches, so a run
can show which kernels its main path went through.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(os.path.dirname(_PKG), ".build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int

# Entry point -> argument types (pointers, the consts block and the stream
# are c_void_p; sizes are int64).
CUDA_ENTRIES = {
    "kzg_fr_mul": [_P, _I64, _I64, _P, _I64, _I64, _P, _I64, _P, _P],
    "kzg_fr_add": [_P, _I64, _I64, _P, _I64, _I64, _P, _I64, _P, _P],
    "kzg_fr_sub": [_P, _I64, _I64, _P, _I64, _I64, _P, _I64, _P, _P],
    "kzg_g1_add": [_P, _P, _P, _I64, _P, _P],
    "kzg_g1_double": [_P, _P, _I64, _P, _P],
    "kzg_ntt_stage": [_P, _P, _P, _I64, _I64, _INT, _P, _P],
    "kzg_msm_bucket": [_P, _P, _I64, _P, _P, _I64, _I64, _INT, _INT, _P, _P],
}

HOST_ENTRIES = {
    "host_fr_ewise": [_INT, _P, _I64, _I64, _P, _I64, _I64, _P, _I64, _P],
    "host_g1_add": [_P, _P, _P, _I64, _P],
    "host_g1_double": [_P, _P, _I64, _P],
    "host_ntt_radix2": [_P, _P, _P, _I64, _I64, _P],
    "host_ntt_radix4": [_P, _P, _P, _I64, _I64, _P],
    "host_msm_bucket": [_P, _P, _I64, _P, _P, _I64, _I64, _INT, _INT, _P],
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

LAUNCHES: collections.Counter = collections.Counter()


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    LAUNCHES.clear()


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _digest(files: list[str], flags: list[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    for path in files:
        h.update(path.encode())
    return h.hexdigest()[:16]


def _build(kind: str, lib_name: str, compiler: list[str], sources: list[str],
           flags: list[str]) -> str:
    """Compile ``sources`` into .build/<kind>/<hash>/<lib_name> under a file
    lock; returns the library path."""
    rel = [os.path.relpath(s, _CSRC) for s in sources]
    out_dir = os.path.join(_BUILD, kind, _digest(rel, flags))
    lib = os.path.join(out_dir, lib_name)
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_BUILD, kind, "build.lock"), "w") as lock_fh:
        fcntl.flock(lock_fh, fcntl.LOCK_EX)
        if os.path.exists(lib):
            return lib
        tmp = lib + f".tmp{os.getpid()}"
        cmd = compiler + flags + ["-I", _CSRC, "-o", tmp] + sources
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"kernel build failed ({' '.join(cmd)}):\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _load(kind: str, build_fn, entries: dict) -> ctypes.CDLL:
    with _lock:
        if kind not in _libs:
            lib = ctypes.CDLL(build_fn())
            for name, argtypes in entries.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[kind] = lib
        return _libs[kind]


def build_cuda() -> str:
    sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    return _build("torch_kernels", "libkzg_torch.so", [_nvcc()], sources,
                  NVCC_FLAGS)


def cuda_lib() -> ctypes.CDLL:
    """The CUDA kernel library, built from the checkout on first use."""
    return _load("torch_kernels", build_cuda, CUDA_ENTRIES)


def host_lib() -> ctypes.CDLL:
    """The kernels' thread bodies built for the CPU (tests)."""
    def build():
        return _build("torch_host", "libkzg_host.so", ["g++"],
                      [os.path.join(_CSRC, "host_check.cpp")], GXX_FLAGS)
    return _load("torch_host", build, HOST_ENTRIES)
