"""Builds and loads the port's hand-written kernels.

``cuda_lib()`` compiles every ``kzg_snark_tpu_torch/csrc/*.cu`` into
``.build/torch_kernels/<hash>/libkzg_torch.so`` (plain C entry points,
loaded with ctypes) the first time a kernel is launched: one ``nvcc -c``
per source, all started together, then one link.  Each source holds its
kernels at both limb counts (8 and 12 words; ``csrc/field.cuh``).  The
hash covers the sources and the flags, so an edited source builds anew.
The compilers' messages (``-Xptxas -v``: registers, stack and spills of
every kernel instantiation) go to ``build.log`` beside the library
(``kernel_resources`` reads them).  An ``fcntl`` lock
lets several processes (pytest workers) share one build.  There is no
fallback: without ``nvcc`` or with a failing build it raises.

``host_lib()`` compiles ``csrc/host_check.cpp`` with g++: the kernels'
thread bodies on the CPU, which the tests compare with the plain versions.
``probe_lib()`` and ``sass_product_counts()`` build
``csrc/probe/mont_probe.cu`` apart from the library: the Montgomery
product policies' throughput loops and their instructions by opcode
(``cuobjdump -sass``), which ``chip_smoke.py``'s build phase prints.

Every kernel wrapper calls :func:`count_launch` where it launches, so a run
can show which kernels its main path went through, over how many elements
or points (:func:`launch_widths`) and at which limb count
(:func:`launch_limbs`).  The multi-device layer counts its collectives
beside them (:func:`count_collective`, :func:`collective_counts`), and
every place where the host waits for the card (a blocking copy, a value
read back, a synchronize) counts its waits under its site's name
(:func:`count_sync`, :func:`sync_counts`), and every bucket MSM call counts
its accumulate's route and the partials it wrote (:func:`count_msm_route`,
:func:`msm_route_counts`).
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(os.path.dirname(_PKG), ".build")

NVCC_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = NVCC_ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                          "-Xptxas", "-v"]
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
    "kzg_g1_add_mixed": [_P, _P, _P, _I64, _P, _I64, _P, _P],
    "kzg_g1_ladder": [_P, _P, _INT, _I64, _P, _I64, _I64, _INT, _P, _P],
    "kzg_g1_blocks_per_sm": [_INT, _INT],
    "kzg_g1_threads": [],
    "kzg_g1_fixed_base_table": [_P, _P, _INT, _INT, _P, _P],
    "kzg_ntt_tile": [_INT],
    "kzg_ntt_pass": [_P, _P, _P, _I64, _INT, _INT, _INT, _P, _P],
    "kzg_fr_butterfly": [_P, _P, _P, _P, _P, _I64, _P, _P],
    "kzg_msm_accumulate": [_P, _P, _P, _P, _I64, _I64, _P, _INT, _P, _P],
    "kzg_msm_acc_blocks_per_sm": [_INT, _INT],
    "kzg_msm_acc_threads": [],
    "kzg_msm_window_sums": [_P, _I64, _P, _I64, _I64, _INT, _I64, _P, _P, _P],
    "kzg_msm_horner": [_P, _I64, _INT, _INT, _INT, _P, _P, _P],
    "kzg_msm_digits": [_P, _I64, _I64, _INT, _INT, _INT, _INT, _I64, _P, _P,
                       _P, _P],
    "kzg_msm_sort_pass": [_P, _P, _P, _P, _P, _I64, _I64, _INT, _I64, _INT,
                          _INT, _INT, _P, _P, _P],
    "kzg_msm_bucket_offsets": [_P, _P, _I64, _I64, _I64, _INT, _INT, _P,
                               _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "kzg_msm_grouped_schedule": [_P, _I64, _I64, _I64, _INT, _INT, _INT, _P,
                                 _P, _P, _P],
    "kzg_msm_accumulate_grouped": [_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                   _INT, _P, _INT, _P, _P],
    "kzg_msm_window_sums_grouped": [_P, _P, _I64, _I64, _I64, _P, _P, _P],
    "kzg_msm_horner_grouped": [_P, _I64, _INT, _INT, _P, _P, _P],
    "kzg_scan_tile": [],
    "kzg_scan_state_words": [_I64],
    "kzg_scan_window": [],
    "kzg_fr_scan": [_P, _I64, _I64, _I64, _INT, _INT, _P, _P, _P, _P, _P],
    "kzg_fr_pow": [_P, _I64, _P, _INT, _P, _P, _P, _P],
}

HOST_ENTRIES = {
    "host_fr_ewise": [_INT, _P, _I64, _I64, _P, _I64, _I64, _P, _I64, _P],
    "host_fe_chain": [_INT, _P, _P, _P, _I64, _P],
    "host_g1_add": [_P, _P, _P, _I64, _P],
    "host_g1_double": [_P, _P, _I64, _P],
    "host_g1_add_mixed": [_P, _P, _P, _I64, _P, _I64, _P],
    "host_g1_ladder": [_P, _P, _INT, _I64, _P, _I64, _I64, _INT, _P],
    "host_fr_butterfly": [_P, _P, _P, _P, _P, _I64, _P],
    "host_ntt_tile": [_INT],
    "host_ntt_pass": [_P, _P, _P, _I64, _INT, _INT, _INT, _P],
    "host_g1_fixed_base_table": [_P, _P, _INT, _INT, _P],
    "host_msm_accumulate": [_P, _P, _P, _P, _I64, _I64, _P, _INT, _P],
    "host_msm_bucket_offsets": [_P, _I64, _I64, _I64, _INT, _INT, _P, _P, _P,
                                _P, _P],
    "host_msm_window_sums": [_P, _I64, _P, _I64, _I64, _INT, _I64, _P, _P],
    "host_msm_horner": [_P, _I64, _INT, _INT, _INT, _P, _P],
    "host_scan_tile": [],
    "host_fr_scan_state": [_INT, _P, _I64, _I64, _I64, _INT, _P, _P, _P,
                           _INT, _INT, _P],
    "host_scan_window": [],
    "host_scan_state_words": [_I64],
    "host_fr_pow": [_P, _I64, _P, _INT, _P, _P, _P],
    "host_fe_inv": [_P, _P, _I64, ctypes.c_uint32, _P],
    "host_pow_route": [_P, _P],
}

# Entry points that return an int64 (the others return an int: 0 or a CUDA
# error).
INT64_RESULTS = ("kzg_scan_state_words", "host_scan_state_words")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

LAUNCHES: collections.Counter = collections.Counter()
# (name, width class) -> launches, for wrappers that give their width.
LAUNCH_WIDTHS: collections.Counter = collections.Counter()
# (name, limb count) -> launches.
LAUNCH_LIMBS: collections.Counter = collections.Counter()
# collective -> calls and bytes that crossed between ranks (parallel/mesh).
COLLECTIVES: collections.Counter = collections.Counter()
COLLECTIVE_BYTES: collections.Counter = collections.Counter()
# site -> host waits on the device.
SYNCS: collections.Counter = collections.Counter()
# MSM route -> bucket MSM calls and the chunk partials their accumulate wrote.
MSM_ROUTES: collections.Counter = collections.Counter()
MSM_PARTIALS: collections.Counter = collections.Counter()


def _width_class(width: int) -> str:
    return "<=256" if width <= 256 else ">=2^14" if width >= 1 << 14 \
        else "257..2^14-1"


def count_launch(name: str, launches: int = 1, width: int | None = None,
                 limbs: int | None = None) -> None:
    """Count ``launches`` kernel launches of ``name``, over ``width``
    elements or points and at ``limbs`` words an element if given."""
    LAUNCHES[name] += launches
    if width is not None:
        LAUNCH_WIDTHS[name, _width_class(width)] += launches
    if limbs is not None:
        LAUNCH_LIMBS[name, limbs] += launches


def count_collective(name: str, nbytes: int) -> None:
    """Count one collective ``name`` that moved ``nbytes`` between this
    rank and the others (not a kernel launch)."""
    COLLECTIVES[name] += 1
    COLLECTIVE_BYTES[name] += nbytes


def count_sync(site: str, waits: int = 1) -> None:
    """Count ``waits`` host waits on the device at ``site``.  Counted where
    the site is passed, whatever the device, so a CPU run counts what a
    card's run would wait for."""
    SYNCS[site] += waits


def count_msm_route(route: str, partials: int) -> None:
    """Count one bucket MSM call on ``route`` ("chunks" or "ranges",
    ``ops/msm_kernel.accumulate_run``) that wrote ``partials`` chunk
    partials.  The count is read with the schedule's one wait, so it costs
    none."""
    MSM_ROUTES[route] += 1
    MSM_PARTIALS[route] += partials


def reset_launches() -> None:
    """Set the launch, collective, sync and MSM route counts to 0."""
    LAUNCHES.clear()
    LAUNCH_WIDTHS.clear()
    LAUNCH_LIMBS.clear()
    COLLECTIVES.clear()
    COLLECTIVE_BYTES.clear()
    SYNCS.clear()
    MSM_ROUTES.clear()
    MSM_PARTIALS.clear()


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def sync_counts() -> dict[str, int]:
    """{site: host waits} since the last reset."""
    return dict(SYNCS)


def msm_route_counts() -> dict[str, dict[str, int]]:
    """{route: {"calls": k, "partials": p}} since the last reset."""
    return {route: {"calls": k, "partials": MSM_PARTIALS[route]}
            for route, k in sorted(MSM_ROUTES.items())}


def collective_counts() -> dict[str, dict[str, int]]:
    """{collective: {"calls": k, "bytes": b}} since the last reset."""
    return {name: {"calls": k, "bytes": COLLECTIVE_BYTES[name]}
            for name, k in sorted(COLLECTIVES.items())}


def launch_widths() -> dict[str, dict[str, int]]:
    """{name: {width class: launches}} since the last reset."""
    out: dict[str, dict[str, int]] = {}
    for (name, cls), k in sorted(LAUNCH_WIDTHS.items()):
        out.setdefault(name, {})[cls] = k
    return out


def launch_limbs() -> dict[str, dict[int, int]]:
    """{name: {limb count: launches}} since the last reset."""
    out: dict[str, dict[int, int]] = {}
    for (name, limbs), k in sorted(LAUNCH_LIMBS.items()):
        out.setdefault(name, {})[limbs] = k
    return out


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _digest(files: list[str], flags: list[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC, "*"))):
        if not os.path.isfile(path):
            continue
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    for path in files:
        h.update(path.encode())
        with open(os.path.join(_CSRC, path), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> list[str]:
    """Run the commands side by side; raise with the first failure's
    compiler output, else return each command's messages."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed, logs = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}{err}")
        if proc.returncode != 0:
            failed.append(f"kernel build failed ({' '.join(cmd)}):\n{err}")
    if failed:
        raise RuntimeError(failed[0])
    return logs


def _build(kind: str, lib_name: str, sources: list[str], flags: list[str],
           steps) -> str:
    """Build ``sources`` into .build/<kind>/<hash>/<lib_name> under a file
    lock; ``steps(out_dir, tmp_lib)`` gives the command batches, run in
    order, the commands of a batch side by side.  Returns the library."""
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
        logs = []
        for batch in steps(out_dir, tmp):
            logs += _run(batch)
        with open(os.path.join(out_dir, "build.log"), "w") as fh:
            fh.write("\n".join(logs))
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
                fn.restype = _I64 if name in INT64_RESULTS else _INT
            _libs[kind] = lib
        return _libs[kind]


def build_cuda() -> str:
    """Compile each .cu apart, all at once, then link the library."""
    sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    nvcc = _nvcc()

    def steps(out_dir, tmp):
        tag = f".{os.getpid()}.o"
        objs = [os.path.join(out_dir, os.path.basename(src) + tag)
                for src in sources]
        compile_cmds = [[nvcc] + NVCC_FLAGS + ["-I", _CSRC, "-c", "-o", obj,
                                               src]
                        for src, obj in zip(sources, objs)]
        return [compile_cmds, [[nvcc] + NVCC_ARCH + ["-shared", "-o", tmp]
                               + objs]]

    return _build("torch_kernels", "libkzg_torch.so", sources, NVCC_FLAGS,
                  steps)


def kernel_resources(lib_path: str) -> dict[str, dict[str, int]]:
    """{kernel instantiation: {"registers", "stack", "spill_stores",
    "spill_loads"}} from the ``-Xptxas -v`` messages of the build of
    ``lib_path``, names demangled when ``c++filt`` is there."""
    with open(os.path.join(os.path.dirname(lib_path), "build.log")) as fh:
        lines = fh.read().splitlines()
    found: dict[str, dict[str, int]] = {}
    name = None
    for line in lines:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            found[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            found[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found[name]["registers"] = int(m.group(1))
    if found and shutil.which("c++filt"):
        names = list(found)
        out = subprocess.run(["c++filt"], input="\n".join(names), text=True,
                             capture_output=True, check=True).stdout
        found = dict(zip(out.splitlines(), found.values()))
    return found


def probe_lib() -> ctypes.CDLL:
    """``csrc/probe/mont_probe.cu`` built apart from the kernel library:
    the product policies' throughput loops (``kzg_probe_loop``), the
    window-sum piece's double-and-add (``kzg_probe_piece_scale``) and
    dependent inversions by safegcd or by Fermat's chain
    (``kzg_probe_inv``)."""
    src = os.path.join(_CSRC, "probe", "mont_probe.cu")

    def build():
        return _build("torch_probe", "libmont_probe.so", [src], NVCC_FLAGS,
                      lambda out_dir, tmp: [[[_nvcc()] + NVCC_FLAGS + [
                          "-I", _CSRC, "-shared", "-o", tmp, src]]])
    return _load("torch_probe", build, {
        "kzg_probe_loop": [_INT, _INT, _P, _P, _P, _I64, _INT, _P, _P],
        "kzg_probe_piece_scale": [_P, _P, _I64, _INT, _INT, _P, _P, _P],
        "kzg_probe_inv": [_INT, _P, _P, _I64, _INT, _P, _INT, _P, _P, _P]})


def sass_product_counts(lib_path: str) -> dict[str, dict[str, int]]:
    """Instructions of one Montgomery product and squaring by policy and
    limb count: ``csrc/probe/mont_probe.cu`` compiled to a cubin beside
    ``lib_path`` and read with ``cuobjdump -sass``; each probe kernel's
    opcode counts less those of ``probe_copy`` at its limb count.  Keys
    "<kernel> <policy> <limbs>"; per entry "total", "imad" (IMAD of any
    form but IMAD.MOV, a move) and "ops", the count of every opcode.
    Raises where the toolkit has no ``cuobjdump``."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_nvcc()), "cuobjdump")
    src = os.path.join(_CSRC, "probe", "mont_probe.cu")
    cubin = os.path.join(os.path.dirname(lib_path), "mont_probe.cubin")
    if not os.path.exists(cubin):
        _run([[_nvcc()] + NVCC_ARCH + ["-std=c++17", "-O3", "-cubin",
                                       "-I", _CSRC, "-o", cubin, src]])
    sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    counts: dict[str, collections.Counter] = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if m and name:
            counts[name][m.group(1)] += 1
    names = list(counts)
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               text=True, capture_output=True,
                               check=True).stdout.splitlines()
    by_name = dict(zip(names, counts.values()))
    policies = {"0": "cios", "2": "chain"}
    out: dict[str, dict[str, int]] = {}
    for full, c in by_name.items():
        m = re.match(r"void probe_(mul|sqr)<(\d+), (\d+)>", full)
        if not m:
            continue
        base = next(v for k, v in by_name.items()
                    if k.startswith(f"void probe_copy<{m.group(3)}>"))
        diff = c.copy()
        diff.subtract(base)
        ops = {k: v for k, v in diff.items() if v}
        imad = {k: v for k, v in ops.items()
                if k.startswith("IMAD") and not k.startswith("IMAD.MOV")}
        key = f"{m.group(1)} {policies.get(m.group(2), m.group(2))} " \
              f"{m.group(3)}"
        out[key] = {"total": sum(ops.values()), "imad": sum(imad.values()),
                    "ops": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}
    return out


def cuda_lib() -> ctypes.CDLL:
    """The CUDA kernel library, built from the checkout on first use."""
    return _load("torch_kernels", build_cuda, CUDA_ENTRIES)


def host_lib() -> ctypes.CDLL:
    """The kernels' thread bodies built for the CPU (tests)."""
    src = os.path.join(_CSRC, "host_check.cpp")

    def build():
        return _build("torch_host", "libkzg_host.so", [src], GXX_FLAGS,
                      lambda out_dir, tmp: [[["g++"] + GXX_FLAGS + [
                          "-I", _CSRC, "-o", tmp, src]]])
    return _load("torch_host", build, HOST_ENTRIES)
