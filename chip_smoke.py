#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (kzg_snark_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order, one printed line or block each:
  device   the card's name and power limit (nvidia-smi)
  build    nvcc build of kzg_snark_tpu_torch/csrc/*.cu, timed
  kernels  every kernel entry point against its plain PyTorch version on
           the card at the main path's shapes: exact equality, both times
  ntt      NTT at n = 2^18: forward + inverse round trip, host spot checks
  msm      MSM at 2^16 points on a random-multiplier basis vs the host
           oracle (sum s_i k_i) G
  parity   PLONK at n = 2^6: the port's proof byte-identical to the host
           prover's (normalized commitments)
  main     PLONK at n = 2^16 (the BASELINE circuit): index, two proves,
           host verification, tamper rejection, phase map, peak memory and
           the kernel launch counts of that run

The second-to-last lines are the kernels JSON and the nvidia-smi line; the
last line is the result JSON.  Any failure raises (non-zero exit, no result
line).  Without a CUDA device the script exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# Kernels the main path launches: source file and the TPU kernel each
# replaces (fr_add / fr_sub are entry points of the K1 file; the radix-4
# NTT stage also replaces ntt_stage.py:202).  The radix-2 stage (K3 / K5)
# is compared below too, but n = 2^16 and 4n = 2^18 take radix-4 passes
# only, so the main path never launches it.
KERNELS = {
    "fr_mul": ("kzg_snark_tpu_torch/csrc/fr_kernels.cu",
               "kzg_snark_tpu/ops/pallas_fr.py:114"),
    "fr_add": ("kzg_snark_tpu_torch/csrc/fr_kernels.cu",
               "kzg_snark_tpu/ops/pallas_fr.py:114"),
    "fr_sub": ("kzg_snark_tpu_torch/csrc/fr_kernels.cu",
               "kzg_snark_tpu/ops/pallas_fr.py:114"),
    "ntt_radix4": ("kzg_snark_tpu_torch/csrc/ntt_kernels.cu",
                   "kzg_snark_tpu/ops/ntt_stage.py:141"),
    "g1_add": ("kzg_snark_tpu_torch/csrc/curve_kernels.cu",
               "kzg_snark_tpu/ops/pallas_fr.py:232"),
    "g1_double": ("kzg_snark_tpu_torch/csrc/curve_kernels.cu",
                  "kzg_snark_tpu/ops/pallas_fr.py:289"),
    "msm_bucket": ("kzg_snark_tpu_torch/csrc/msm_kernels.cu",
                   "kzg_snark_tpu/ops/msm_kernel.py:172"),
}
FAMILIES = {"field": ["fr_mul", "fr_add", "fr_sub"],
            "ntt": ["ntt_radix4", "ntt_radix2"],
            "curve": ["g1_add", "g1_double"], "msm": ["msm_bucket"]}

MAIN_LOG_N = 16
PARITY_LOG_N = 6
TAU = 0xABCDEF12345


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def timed_ms(torch, fn, reps: int) -> tuple[float, float]:
    """(device ms, wall ms) per call of ``fn``: means over ``reps`` calls
    after one warm-up.

    Wall time is the host clock around the calls and a final sync.  For
    device time the same calls are queued behind a spin kernel, so the
    CUDA events see the device's own time and not the host's dispatch
    gaps (a small kernel runs faster than Python can launch it).  Work
    that overflows the launch queue still waits on the host, and its
    device time can then exceed its wall time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # Spin at least 10 ms (~2e9 cycles/s), which also lifts an idle card's
    # clocks before the first timed launch.
    torch.cuda._sleep(int(max(0.01, min(2 * wall_s, 0.5)) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, wall_s * 1e3 / reps


def random_canonical(torch, n: int, seed: int, dev):
    """(8, n) int32 limbs of uniform values below 2^253 (< r < p)."""
    import numpy as np
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(8, n),
                                             dtype=np.uint64)
    w[7] &= (1 << 29) - 1
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)


def compare(torch, name, results, kernel_fn, plain_fn, reps=20,
            plain_reps=3):
    """Run kernel and plain version on the same CUDA inputs; demand exact
    equality; record both times."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain (max |diff| {err})")
    dev_ms, wall = timed_ms(torch, kernel_fn, reps)
    plain_dev, plain_wall = timed_ms(torch, plain_fn, plain_reps)
    # A call costs its device time unless the host cannot keep up; the
    # plain versions' thousands of small launches overflow the queue.
    results[name] = {"max_abs_err": err, "ms": min(dev_ms, wall),
                     "plain_ms": min(plain_dev, plain_wall)}
    log(f"[kernels] {name}: exact, device ms: kernel {dev_ms:.4f}, plain "
        f"{plain_dev:.4f}; wall ms per call: kernel {wall:.4f}, plain "
        f"{plain_wall:.4f}; shape {tuple(got.shape)}")


def phase_kernels(torch, dev, results):
    from kzg_snark_tpu_torch.ops import cuda_fr
    from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
    from kzg_snark_tpu_torch.ops.fr import fq_backend, fr_backend
    from kzg_snark_tpu_torch.ops.msm_kernel import (lanes_for, msm_bucket,
                                                    msm_bucket_plain,
                                                    signed_digits)
    from kzg_snark_tpu_torch.ops.ntt import ntt_context
    from kzg_snark_tpu_torch.ops.ntt_stage import (ntt_stage, radix2_plain,
                                                   radix4_plain)

    fr = fr_backend("bn254", dev).consts
    fq = fq_backend("bn254", dev).consts
    n_field = 1 << (MAIN_LOG_N + 2)
    a = random_canonical(torch, n_field, 1, dev)
    b = random_canonical(torch, n_field, 2, dev)
    for name, k, p in [("fr_mul", cuda_fr.fr_mul, cuda_fr.mul_plain),
                       ("fr_add", cuda_fr.fr_add, cuda_fr.add_plain),
                       ("fr_sub", cuda_fr.fr_sub, cuda_fr.sub_plain)]:
        compare(torch, name, results, lambda: k(fr, a, b),
                lambda: p(fr, a, b))
    s = b[:, :1].contiguous()
    compare(torch, "fr_mul_scalar", {}, lambda: cuda_fr.fr_mul(fr, a, s),
            lambda: cuda_fr.mul_plain(fr, a, s))

    npts = 1 << MAIN_LOG_N
    pts, _ = random_point_basis("bn254", npts, seed=5, device=dev)
    q = cuda_fr.g1_double(fq, pts.roll(1, -1).contiguous())
    k = 64          # equal, opposite and identity cases in the first lanes
    q[:, :, :2 * k] = pts[:, :, :2 * k]
    q[1, :, k:2 * k] = cuda_fr.fr_sub(fq, torch.zeros_like(pts[1, :, :k]),
                                      pts[1, :, k:2 * k].contiguous())
    q[2, :, 2 * k:3 * k] = 0
    q = q.contiguous()
    compare(torch, "g1_add", results, lambda: cuda_fr.g1_add(fq, pts, q),
            lambda: cuda_fr.g1_add_plain(fq, pts, q), plain_reps=1)
    compare(torch, "g1_double", results, lambda: cuda_fr.g1_double(fq, q),
            lambda: cuda_fr.g1_double_plain(fq, q), plain_reps=1)

    ctx = ntt_context("bn254", n_field, dev)
    x = a
    compare(torch, "ntt_radix4", results,
            lambda: ntt_stage(fr, x, ctx.tw_fwd, 1024, 4),
            lambda: radix4_plain(fr, x, ctx.tw_fwd, 1024))
    for span in (1, n_field // 2):
        compare(torch, f"ntt_stage_radix2_span{span}", results,
                lambda: ntt_stage(fr, x, ctx.tw_fwd, span, 2),
                lambda: radix2_plain(fr, x, ctx.tw_fwd, span))
    compare(torch, "ntt_stage_radix4_span1", results,
            lambda: ntt_stage(fr, x, ctx.tw_fwd, 1, 4),
            lambda: radix4_plain(fr, x, ctx.tw_fwd, 1))

    lanes = lanes_for(npts)
    dig = signed_digits(random_canonical(torch, npts, 3, dev), 254)
    px, py = pts[0].contiguous(), pts[1].contiguous()
    compare(torch, "msm_bucket", results,
            lambda: msm_bucket(fq, px, py, dig, lanes, False),
            lambda: msm_bucket_plain(fq, px, py, dig, lanes, False),
            reps=3, plain_reps=1)
    m = 4096
    pxs, pys, digs = px[:, :m].contiguous(), py[:, :m].contiguous(), \
        dig[:, :m].contiguous()
    compare(torch, "msm_bucket_complete_4096", results,
            lambda: msm_bucket(fq, pxs, pys, digs, lanes_for(m), True),
            lambda: msm_bucket_plain(fq, pxs, pys, digs, lanes_for(m), True),
            reps=3, plain_reps=1)


def phase_ntt(torch, dev):
    from kzg_snark_tpu.ops.host.field import scalar_field
    from kzg_snark_tpu_torch.ops.ntt import ntt_context

    n = 1 << (MAIN_LOG_N + 2)
    ctx = ntt_context("bn254", n, dev)
    be = ctx.backend
    x = be.to_mont(random_canonical(torch, n, 7, dev))
    fwd_ms, fwd_wall = timed_ms(torch, lambda: ctx.ntt(x), 5)
    inv_ms, inv_wall = timed_ms(torch, lambda: ctx.intt(x), 5)
    y = ctx.ntt(x)
    back = ctx.intt(y)
    if not torch.equal(back, x):
        raise AssertionError("NTT 2^18 round trip differs")
    Fr = scalar_field("bn254")
    r = Fr.modulus
    coeffs = be.to_ints(x)
    evals = be.to_ints(y)
    for j in (0, 1, 12345, n - 1):
        pt = pow(ctx.root, j, r)
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * pt + c) % r
        if acc != evals[j]:
            raise AssertionError(f"NTT 2^18 output {j} != host Horner")
    log(f"[ntt] n=2^18 round trip exact, 4 outputs == host Horner; device "
        f"ms: ntt {fwd_ms:.3f}, intt {inv_ms:.3f}; wall ms: ntt "
        f"{fwd_wall:.3f}, intt {inv_wall:.3f}")


def phase_msm(torch, dev):
    import numpy as np
    from kzg_snark_tpu import constants as C
    from kzg_snark_tpu.ops.host import curve as hc
    from kzg_snark_tpu.ops.host.field import base_field
    from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
    from kzg_snark_tpu_torch.ops.limbs import (ints_to_words, to_tensor,
                                               words_to_ints)
    from kzg_snark_tpu_torch.ops.msm import msm_context

    n = 1 << MAIN_LOG_N
    t0 = time.perf_counter()
    pts, ks = random_point_basis("bn254", n, seed=20260820, device=dev)
    torch.cuda.synchronize()
    basis_s = time.perf_counter() - t0
    ctx = msm_context("bn254", dev)
    r = C.BN254_R
    w = np.random.default_rng(9000).integers(0, 1 << 32, size=(8, n),
                                              dtype=np.uint64)
    w[7] &= (1 << 29) - 1
    words = w.astype(np.uint32)
    special = [0, 1, r - 1, 2, r - 2]
    words[:, :len(special)] = ints_to_words(special)
    scalars = to_tensor(words, dev)
    ms, wall = timed_ms(torch, lambda: ctx.msm(pts, scalars), 3)
    got = ctx.curve.to_affine_ints(ctx.msm(pts, scalars))[0]
    total = sum(s * k for s, k in zip(words_to_ints(words), ks)) % r
    Fp = base_field("bn254")
    exp = hc.normalize(hc.multiply((Fp(1), Fp(2), Fp(1)), total))
    exp = None if exp is None else (int(exp[0]), int(exp[1]))
    if got != exp:
        raise AssertionError("MSM 2^16 differs from the host oracle")
    log(f"[msm] 2^16 points == host oracle; device {ms:.3f} ms, wall "
        f"{wall:.3f} ms ({n / wall * 1e3:.0f} points/s), basis build "
        f"{basis_s:.2f} s")


def _circuit(Fr, n):
    one, zero = Fr(1), Fr(0)
    a = [Fr(i + 2) for i in range(n)]
    b = [Fr(i + 3) for i in range(n)]
    c = [x * y for x, y in zip(a, b)]
    return ([one] * n, [zero] * n, [-one] * n, list(range(3 * n)),
            a + b + c)


def phase_parity(dev):
    from kzg_snark_tpu.models.plonk.indexer import Indexer
    from kzg_snark_tpu.models.plonk.prover import Prover
    from kzg_snark_tpu.ops.host.field import scalar_field
    from kzg_snark_tpu.rng import Rng
    from kzg_snark_tpu_torch.models.plonk.device import DeviceProver

    n = 1 << PARITY_LOG_N
    qM, qZ, qO, perm, w = _circuit(scalar_field("bn254"), n)
    args = (qM, qZ, qZ, qO, qZ, perm)
    ipk_d, ivk_d = DeviceProver("bn254", rng=Rng(600), device=dev) \
        .preprocess(*args, max_degree=n + 5, tau=TAU)
    proof_d = DeviceProver("bn254", rng=Rng(601), device=dev).prove(
        ipk_d, [], w)
    idx = Indexer("bn254", backend="host", rng=Rng(600))
    idx.kzg.normalize_commitments = True
    ipk_h, ivk_h = idx.preprocess(*args, max_degree=n + 5, tau=TAU)
    prover = Prover("bn254", backend="host", rng=Rng(601))
    prover.kzg.normalize_commitments = True
    proof_h = prover.prove(ipk_h, [], w)
    if ivk_d["commitments"] != ivk_h["commitments"]:
        raise AssertionError("n=2^6 index commitments differ from host")
    for part in ("commitments", "evaluations", "kzg_proofs"):
        if proof_d[part] != proof_h[part]:
            raise AssertionError(f"n=2^6 proof {part} differ from host")
    log("[parity] n=2^6 index and proof byte-identical to the host prover")


def phase_main(torch, dev):
    from kzg_snark_tpu.models.plonk.verifier import Verifier
    from kzg_snark_tpu.ops.host.field import scalar_field
    from kzg_snark_tpu.rng import Rng
    from kzg_snark_tpu_torch.models.plonk.device import DeviceProver
    from kzg_snark_tpu_torch.utils.build import launch_counts, reset_launches

    n = 1 << MAIN_LOG_N
    qM, qZ, qO, perm, w = _circuit(scalar_field("bn254"), n)
    prover = DeviceProver("bn254", rng=Rng(77), collect_timings=True,
                          device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ipk, ivk = prover.preprocess(qM, qZ, qZ, qO, qZ, perm,
                                 max_degree=n + 5, tau=TAU)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    prove_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        proof = prover.prove(ipk, [], w)
        torch.cuda.synchronize()
        prove_s.append(time.perf_counter() - t0)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    phases = {k: round(v * 1e3, 3) for k, v in prover.timings.items()}

    t0 = time.perf_counter()
    ok = Verifier("bn254", rng=Rng(78)).verify(ivk, [], proof)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("host Verifier rejected the n=2^16 proof")
    proof["evaluations"]["a"] = proof["evaluations"]["a"] + 1
    if Verifier("bn254", rng=Rng(79)).verify(ivk, [], proof):
        raise AssertionError("host Verifier accepted a tampered proof")
    log(f"[main] PLONK n=2^16: index {index_s:.3f} s, prove "
        f"{prove_s[0]:.3f} s then {prove_s[1]:.3f} s, host verify "
        f"{verify_s:.3f} s: accepted, tampered rejected")
    log(f"[main] phases of the second prove (ms): {json.dumps(phases)}; "
        f"sum {sum(phases.values()):.3f} ms")
    log(f"[main] peak device memory {peak} bytes "
        f"({peak / 2 ** 30:.3f} GiB)")
    log(f"[main] launches: {json.dumps(counts, sort_keys=True)}")
    for fam, names in FAMILIES.items():
        if sum(counts.get(nm, 0) for nm in names) == 0:
            raise AssertionError(f"kernel family {fam} never launched")
    for name in KERNELS:
        if counts.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} never launched")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kzg_snark_tpu_torch.utils.build import build_cuda, cuda_lib

    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib_path = build_cuda()
    cuda_lib()
    log(f"[build] {lib_path} in {time.perf_counter() - t0:.2f} s")

    results: dict = {}
    phase_kernels(torch, dev, results)
    phase_ntt(torch, dev)
    phase_msm(torch, dev)
    phase_parity(dev)
    counts = phase_main(torch, dev)

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": counts[name], **results[name]}
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
