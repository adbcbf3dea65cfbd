"""Dry run of the multi-device path on spawned ranks.

The counterpart of ``__graft_entry__.dryrun_multichip`` (one mesh axis)
and, with ``--hosts H``, of ``kzg_snark_tpu/parallel/multihost_dryrun.py``
(the (host, chip) mesh)::

    python -m kzg_snark_tpu_torch.parallel.dryrun --ranks 4 --backend gloo \\
        --device cuda --log2n 20 --log2msm 20 [--log2small 10] [--hosts 2] \\
        [--bls 16] [--out DIR]

spawns the ranks (``torch.multiprocessing``, one process a rank; on the
card rank r drives ``cuda:r % device_count``, so gloo can put several
ranks on one card, which NCCL refuses), runs the checks, prints one OK
line per check from rank 0 and exits non-zero if any rank fails.  The
checks, each against a reference that needs no mesh:

* ``ntt``: ``DistNttContext`` at n = 2^K (four-step; ``small`` where
  n < D^2): the gathered output equal word for word to the single-device
  ``NttContext`` on the same input, and the iNTT round trip; on the card
  (staged mode) one transform's column step makes the plan's ``ntt_pass``
  launches at n / D and its row step log2(D) ``fr_butterfly`` launches;
* ``ntt_small`` (D > 1): the same at n = D^2 / 2, the ``small`` fallback;
* ``msm``: ``DistMsmContext.msm`` at N = 2^M on ``random_point_basis``
  against the host oracle (sum s_i k_i mod r) G, and rank 0's
  single-device ``MsmContext.msm`` of the same inputs;
* ``msm_scan``: the same at D x 512 points (each shard on the scan route,
  K9), against the oracle;
* ``msm_small``: ``msm_small`` at N = 2^S on the points (i + 1) G with
  127-bit scalars (the JAX dry run's), against the oracle;
* with ``--hosts H`` the (host, chip) checks of ``multihost_dryrun``;
* with ``--bls B`` ``ntt`` and ``msm`` at 2^B on BLS12-381.

Each check records, on each rank, the device and wall ms of its call (the
mean over ``REPS`` calls after a warm-up on the card; one call on the
CPU, where the device ms are not measured), the kernel launches and the
collectives (calls and bytes) of one call, with the counts set to 0 just
before it and read just after, the collective's own ms, and on rank 0 the
single-device call's ms.  ``launch`` returns each rank's record.
"""

from __future__ import annotations

import argparse
import os
import pickle
import random
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import env_ntt_mode
from ..ops.benchpoints import random_point_basis
from ..ops.g1 import generator
from ..ops.host import curve as hc
from ..ops.host.field import base_field, scalar_field
from ..ops.limbs import ints_to_words, to_tensor, to_words, words_to_ints
from ..ops.msm import MsmContext, msm_context
from ..ops.ntt import ntt_context
from ..ops.ntt_stage import pass_plan, tile_bits
from ..utils.build import (collective_counts, cuda_lib, launch_counts,
                           reset_launches)
from .mesh import all_gather, all_to_all, init_ranks, make_mesh
from .msm_dist import DistMsmContext
from .multihost import CHIP_AXIS, HOST_AXIS, make_mesh2, msm_multihost
from .ntt_dist import DistNttContext

REPS = 3                    # timed calls of a check on the card
SCAN_POINTS = 512           # a rank's shard in the msm_scan check


# -- spawning ----------------------------------------------------------------
def _rank_entry(rank: int, world: int, backend, device: str, workdir: str,
                target, args) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    init_ranks(backend, f"file://{os.path.join(workdir, 'store')}", world,
               rank, device)
    try:
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if device == "cuda" else torch.device("cpu")
        out = target(dev, *args)
        tmp = os.path.join(workdir, f"rank{rank}.tmp")
        with open(tmp, "wb") as fh:
            pickle.dump(out, fh)
        os.replace(tmp, os.path.join(workdir, f"rank{rank}.pkl"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(target, ranks: int, args=(), *, backend: str | None = None,
           device: str = "cuda", workdir: str | None = None,
           timeout: float = 1800.0) -> list:
    """Run ``target(device, *args)`` on ``ranks`` spawned ranks joined by
    ``backend`` (NCCL on the card, gloo on the CPU when None) and return
    each rank's result, in rank order.  ``target`` is a function of an
    importable module; its result is pickled through ``workdir`` (a new
    temporary directory when None).  Raises if a rank fails (the others
    are then stopped) or if the ranks outlast ``timeout`` seconds (all are
    then killed)."""
    with tempfile.TemporaryDirectory() as tmp:
        workdir = os.path.abspath(workdir or tmp)
        store = os.path.join(workdir, "store")
        if os.path.exists(store):
            os.remove(store)
        ctx = torch.multiprocessing.start_processes(
            _rank_entry, args=(ranks, backend, device, workdir, target, args),
            nprocs=ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                    proc.join()
                raise TimeoutError(f"{ranks} ranks ran past {timeout} s")
        out = []
        for r in range(ranks):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out


# -- measuring ---------------------------------------------------------------
def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(dev, fn):
    """(fn's output, record) of one counted call: launches and collectives
    set to 0 just before it and read just after; on the card after one
    warm-up and with ``REPS`` calls timed (device ms by CUDA events, wall
    ms by the host clock after a sync), on the CPU one call, its device
    ms None."""
    cuda = dev.type == "cuda"
    if cuda:
        fn()
    device_ms, wall_ms, out, counts = [], [], None, None
    for i in range(REPS if cuda else 1):
        _sync(dev)
        if i == 0:
            reset_launches()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        res = fn()
        if cuda:
            end.record()
        _sync(dev)
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            device_ms.append(start.elapsed_time(end))
        if i == 0:
            out, counts = res, (launch_counts(), collective_counts())
    return out, {"device_ms": float(np.mean(device_ms)) if cuda else None,
                 "wall_ms": float(np.mean(wall_ms)),
                 "launches": counts[0], "collectives": counts[1]}


def single_device_ms(dev, fn) -> dict | None:
    """Rank 0's ms of the single-device call, the other ranks held at a
    barrier meanwhile; None on the other ranks."""
    dist.barrier()
    rec = measure(dev, fn)[1] if dist.get_rank() == 0 else None
    dist.barrier()
    return rec


def log(msg: str) -> None:
    if dist.get_rank() == 0:
        print(f"[dryrun] {msg}", flush=True)


def ms(rec: dict) -> str:
    """"device / wall ms" of a record (the device's not measured on the
    CPU)."""
    dev = "not measured" if rec["device_ms"] is None \
        else f"{rec['device_ms']:.3f}"
    return f"{dev} / {rec['wall_ms']:.3f} ms"


# -- inputs and oracles ------------------------------------------------------
def random_words(n: int, seed: int) -> np.ndarray:
    """(8, n) uint32 words below 2^253: canonical for both curves' Fr."""
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(8, n),
                                             dtype=np.uint64)
    w[-1] &= (1 << 29) - 1
    return w.astype(np.uint32)


def host_oracle(curve_type: str, ks, scalars) -> tuple | None:
    """(sum s_i k_i mod r) G, affine ints (None for the identity)."""
    r = scalar_field(curve_type).modulus
    Fp = base_field(curve_type)
    gx, gy = generator(curve_type)
    total = sum(k * s for k, s in zip(ks, scalars)) % r
    pt = hc.normalize(hc.multiply((Fp(gx), Fp(gy), Fp(1)), total))
    return None if pt is None else (int(pt[0]), int(pt[1]))


def structured_points(curve_type: str, n: int) -> list[tuple[int, int]]:
    """(i + 1) G for i < n, affine ints, by one host add chain."""
    Fp = base_field(curve_type)
    gx, gy = generator(curve_type)
    G = acc = (Fp(gx), Fp(gy), Fp(1))
    out = []
    for _ in range(n):
        ax, ay = hc.normalize(acc)
        out.append((int(ax), int(ay)))
        acc = hc.add(acc, G)
    return out


# -- checks ------------------------------------------------------------------
def check_ntt(out: dict, name: str, mesh, curve_type: str, n: int, dev,
              axis=None) -> None:
    """The distributed NTT of a seeded vector: gathered output equal to
    the single-device transform, the round trip, the launches of one
    transform on the card; times and the collective's ms and bytes."""
    ctx = DistNttContext(curve_type, n, mesh, axis, dev)
    be, D, n2 = ctx.backend, ctx.D, ctx.n2
    x = be.to_mont(to_tensor(random_words(n, 1000 + n), dev))
    xc = ctx.natural_to_cyclic(x)
    y, fwd = measure(dev, lambda: ctx.ntt(xc))
    back, inv = measure(dev, lambda: ctx.intt(y))
    single = ntt_context(curve_type, n, dev)
    if not torch.equal(ctx.blocked_to_natural(y), single.ntt(x)):
        raise AssertionError(f"{name}: n = {n} over {D} ranks differs from "
                             f"the single-device NTT")
    if not torch.equal(back, xc):
        raise AssertionError(f"{name}: n = {n} iNTT round trip differs")
    if dev.type == "cuda" and not ctx.small and env_ntt_mode() != "scan":
        want = {"ntt_pass": len(pass_plan(n2, tile_bits(n2))) if n2 > 1
                else 0, "fr_butterfly": D.bit_length() - 1}
        got = {k: fwd["launches"].get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"{name}: one transform launched {got}, "
                                 f"expected {want}")
    L = be.num_limbs
    if ctx.small:
        buf = torch.zeros((L, n2), dtype=torch.int32, device=dev)
        coll = measure(dev, lambda: all_gather(buf, D, ctx.group))[1]
    else:
        buf = torch.zeros((D, L, n2 // D), dtype=torch.int32, device=dev)
        coll = measure(dev, lambda: all_to_all(buf, ctx.group))[1]
    out[name] = {"curve": curve_type, "n": n, "ranks": D, "small": ctx.small,
                 "ntt": fwd, "intt": inv, "collective": coll,
                 "stats": ctx.collective_stats(),
                 "single_device": single_device_ms(dev,
                                                   lambda: single.ntt(x))}
    log(f"{name}: {curve_type} n = 2^{n.bit_length() - 1} over {D} ranks "
        f"({'small' if ctx.small else 'four-step'}) equal to the "
        f"single-device NTT, round trip exact OK; rank 0 device / wall: "
        f"ntt {ms(fwd)}, intt {ms(inv)}, the collective {ms(coll)}")


def check_msm(out: dict, name: str, mesh, curve_type: str, N: int, dev,
              single: bool = True) -> None:
    """``DistMsmContext.msm`` on a random-multiplier basis against the
    host oracle (and, with ``single``, rank 0's single-device MSM)."""
    pts, ks = basis(curve_type, N, dev)
    words = random_words(N, 2000 + N)
    sc = to_tensor(words, dev)
    dctx = DistMsmContext(curve_type, mesh, dev)
    res, rec = measure(dev, lambda: dctx.msm(pts, sc))
    got = dctx.curve.to_affine_ints(res)[0]
    if got != host_oracle(curve_type, ks, words_to_ints(words)):
        raise AssertionError(f"{name}: {curve_type} N = {N} over {dctx.D} "
                             f"ranks differs from the host oracle")
    part = torch.zeros((3, dctx.curve.num_limbs), dtype=torch.int32,
                       device=dev)
    rec_single = None
    if single:
        base = msm_context(curve_type, dev)
        if dist.get_rank() == 0 and \
                base.curve.to_affine_ints(base.msm(pts, sc))[0] != got:
            raise AssertionError(f"{name}: differs from the single-device "
                                 f"MSM")
        rec_single = single_device_ms(dev, lambda: base.msm(pts, sc))
    out[name] = {"curve": curve_type, "N": N, "ranks": dctx.D,
                 "route": MsmContext.route(N // dctx.D), "msm": rec,
                 "collective": measure(dev, lambda: all_gather(
                     part, dctx.D, dctx.group))[1],
                 "single_device": rec_single}
    log(f"{name}: {curve_type} N = {N} over {dctx.D} ranks "
        f"({MsmContext.route(N // dctx.D)} route a shard) equal to the host "
        f"oracle{' and the single-device MSM' if single else ''} OK; "
        f"rank 0 device / wall {ms(rec)}")


_BASES: dict = {}


def basis(curve_type: str, N: int, dev):
    """``random_point_basis`` of N points (seed N), kept for the rank's
    later checks; a smaller one is a slice of a larger one kept."""
    for (c, m, d), (pts, ks) in _BASES.items():
        if (c, d) == (curve_type, str(dev)) and m >= N:
            return pts[..., :N].contiguous(), ks[:N]
    _BASES[curve_type, N, str(dev)] = random_point_basis(
        curve_type, N, seed=N, device=dev)
    return _BASES[curve_type, N, str(dev)]


def check_msm_small(out: dict, mesh, curve_type: str, N: int, dev) -> None:
    """``msm_small`` on (i + 1) G with 127-bit scalars against the host
    oracle, as the JAX dry run checks it."""
    dctx = DistMsmContext(curve_type, mesh, dev)
    aff = structured_points(curve_type, N)
    pts = dctx.curve.from_affine_ints([p[0] for p in aff],
                                      [p[1] for p in aff])
    rng = random.Random(N)
    scalars = [rng.randrange(1 << 127) for _ in range(N)]
    sc = to_tensor(ints_to_words(scalars), dev)
    res, rec = measure(dev, lambda: dctx.msm_small(pts, sc))
    got = dctx.curve.to_affine_ints(res)[0]
    if got != host_oracle(curve_type, range(1, N + 1), scalars):
        raise AssertionError(f"msm_small: N = {N} over {dctx.D} ranks "
                             f"differs from the host oracle")
    out["msm_small"] = {"curve": curve_type, "N": N, "ranks": dctx.D,
                        "msm": rec, "stats": dctx.collective_stats(N)}
    log(f"msm_small: {curve_type} N = {N} over {dctx.D} ranks "
        f"({dctx.default_chunk(N) // dctx.D} points a rank a step) equal "
        f"to the host oracle OK; rank 0 device / wall {ms(rec)}")


def run_cases(dev, cases: list[dict]) -> dict:
    """A rank target for callers that compare the results elsewhere (the
    tests hold them to the JAX package): each case a dict, "op" "ntt"
    (``curve``, (8, n) ``words`` canonical; ``hosts`` for the two-axis
    mesh) or "msm" (``method`` "msm", "msm_small" or "multihost",
    ``curve``, (3, L, N) int32 ``points`` with Z = 1 and (8, N) uint32
    ``scalars`` canonical; ``impl`` and ``hosts`` for "multihost").  Returns {"cases":
    [numpy words in the port's layout, affine ints, stats], "modules":
    the names of the JAX modules this rank imported, none expected}."""
    D = dist.get_world_size()
    results = []
    for case in cases:
        hosts = case.get("hosts")
        mesh = make_mesh2(hosts, D // hosts, dev.type) if hosts \
            else make_mesh(D, dev.type)
        if case["op"] == "ntt":
            ctx = DistNttContext(case["curve"], case["words"].shape[1], mesh,
                                 (HOST_AXIS, CHIP_AXIS) if hosts else None,
                                 dev)
            x = ctx.backend.to_mont(to_tensor(case["words"], dev))
            y = ctx.ntt(ctx.natural_to_cyclic(x))
            results.append({
                "index": ctx.index, "small": ctx.small,
                "checked": type(ctx.backend).__name__, "y": to_words(y),
                "back": to_words(ctx.intt(y)),
                "natural": to_words(ctx.blocked_to_natural(y)),
                "tw": None if ctx.small else to_words(ctx.tw),
                "stats": ctx.collective_stats()})
            continue
        pts = torch.from_numpy(case["points"]).to(dev)
        sc = to_tensor(case["scalars"], dev)
        if case["method"] == "multihost":
            res = msm_multihost(mesh, pts, sc, case["curve"],
                                case.get("impl", "fused"), dev)
            stats = None
        else:
            dctx = DistMsmContext(case["curve"], mesh, dev)
            res = dctx.msm(pts, sc) if case["method"] == "msm" \
                else dctx.msm_small(pts, sc)
            stats = dctx.collective_stats(pts.shape[-1])
        curve = msm_context(case["curve"], dev).curve
        results.append({"affine": curve.to_affine_ints(res)[0],
                        "stats": stats})
    jax_modules = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "kzg_snark_tpu"))
    return {"cases": results, "modules": jax_modules}


def dryrun_target(dev, opts: dict) -> dict:
    """One rank of the dry run (``opts`` as the command line's)."""
    D = dist.get_world_size()
    out: dict = {"rank": dist.get_rank(), "device": str(dev)}
    mesh = make_mesh(D, dev.type)
    check_ntt(out, "ntt", mesh, "bn254", 1 << opts["log2n"], dev)
    if D > 1:
        check_ntt(out, "ntt_small", mesh, "bn254", D * D // 2, dev)
    check_msm(out, "msm", mesh, "bn254", 1 << opts["log2msm"], dev)
    check_msm(out, "msm_scan", mesh, "bn254", D * SCAN_POINTS, dev,
              single=False)
    check_msm_small(out, mesh, "bn254", 1 << opts["log2small"], dev)
    if opts.get("hosts"):
        from .multihost_dryrun import multihost_checks
        multihost_checks(out, dev, opts["hosts"], opts["log2n"],
                         opts["log2msm"], opts["log2small"])
    if opts.get("bls"):
        check_ntt(out, "bls_ntt", mesh, "bls12_381", 1 << opts["bls"], dev)
        check_msm(out, "bls_msm", mesh, "bls12_381", 1 << opts["bls"], dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--log2n", type=int, required=True)
    ap.add_argument("--log2msm", type=int, required=True)
    ap.add_argument("--log2small", type=int, default=10)
    ap.add_argument("--hosts", type=int, default=None)
    ap.add_argument("--bls", type=int, default=None)
    ap.add_argument("--out", default=None,
                    help="directory for each rank's record (rank<r>.pkl)")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: --device cuda needs a CUDA device", file=sys.stderr)
        return 1
    if a.device == "cuda":
        cuda_lib()                 # build once, before the ranks load it
    if a.out:
        os.makedirs(a.out, exist_ok=True)
    t0 = time.perf_counter()
    opts = {"log2n": a.log2n, "log2msm": a.log2msm,
            "log2small": a.log2small, "hosts": a.hosts, "bls": a.bls}
    try:
        launch(dryrun_target, a.ranks, (opts,), backend=a.backend,
               device=a.device, workdir=a.out)
    except Exception as exc:       # a rank failed: report it, exit non-zero
        print(f"dryrun: FAILED: {exc}", file=sys.stderr)
        return 1
    print(f"[dryrun] every check passed on {a.ranks} ranks "
          f"({a.backend or 'default'} backend, {a.device}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    from kzg_snark_tpu_torch.parallel import dryrun
    sys.exit(dryrun.main())
