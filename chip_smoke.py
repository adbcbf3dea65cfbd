#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (kzg_snark_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order, one printed line or block each:
  device         the card's name and power limit (nvidia-smi)
  build          nvcc build of kzg_snark_tpu_torch/csrc/*.cu (one nvcc per
                 source, side by side), timed
  kernels        every kernel entry point against its plain PyTorch version
                 on the card at the main paths' shapes: exact equality, both
                 times (inputs rotated through copies larger than the L2),
                 and the least time the card could take (bound); the
                 ladder (g1_ladder) at n in {1, 7, 256}, k in {1, 3} on
                 edge scalar sets and scale_const(r - 1), then one small
                 MSM's ladder (n = 256, k = 1) timed, with its bound, its
                 critical-path floor and one thread's products in turn
  chains         fr_scan and fr_pow (K1 as the provers' chains use it) at
                 their edge widths and exponents against their plain
                 versions, their times, one narrow K1 / K7 launch; the SRS
                 table kernel's one-thread doubling chain at 8, 64 and 248
                 doublings
  ntt            ntt_pass against its plain version for every pass of the
                 plan at n in {2, T, 2T, 2^15, 2^16, 2^18}, forward and
                 inverse tables; per-transform device and wall ms at 2^15,
                 2^16 and 2^18 for each tile size tried, beside the bound;
                 at n = 2^18 "scan" mode (K10) equal to "staged", forward
                 and inverse; round trip, host spot checks
  msm            bucket-route MSM at 2^16 points on a random-multiplier basis
                 (built with K9) vs the host oracle (sum s_i k_i) G: random,
                 all-equal, one-nonzero scalars and k = 9 sets; the times of
                 its stages, the launches of one MSM, its operation bounds,
                 and MSM time by window width c at 2^11..2^18 points
  msm_prepared   the bucket-route MSM through FusedMsm.prepare_points and
                 msm_prepared: BN254 at 2^16 and 2^20 (the 2^18 basis
                 tiled, complete adds), BLS12-381 at 2^16, k = 1 and 8
                 sets, each equal to MsmContext.msm (Jacobian words) and
                 to the host oracle (exact digit sums on the host); at
                 2^20 the same MSMs cut into 6 point ranges by a lowered
                 MAX_SCHEDULE_ENTRIES (equal to the unsplit and the
                 oracle, launches per range checked, K6 adds the ranges),
                 device ms split against unsplit; the peak device memory
                 of one MSM at 2^20 and 2^22 points, k = 1 and 8, both
                 curves, in bytes a point
  parity         PLONK at n = 2^6: the port's proof byte-identical to the
                 port's host prover's (normalized commitments)
  main           PLONK at n = 2^16: index, two proves, host verification,
                 tamper rejection, phase map, peak memory, launch counts
                 (also by width; fails above 2000 fr_mul, 600 fr_scan +
                 fr_pow or 32 g1_add launches, on any g1_double or
                 g1_ladder launch, on
                 other than one g1_fixed_base_table launch, and unless
                 ntt_pass makes ceil(log2 n / t) launches a transform, at
                 most 2)
  checked        PLONK at n = 2^16 indexed and proved twice by a fresh
                 prover under KZG_TPU_CHECKED=1 (every field and curve op
                 and PLONK round validated on the card): byte-identical to
                 the main path's, seconds beside the unchecked ones; a
                 planted non-canonical fr_mul output (p added to one
                 column) and g1_add output (one coordinate set to p) trap
                 with the op's name and column
  config         KZG_TPU_NTT_MODE=scan with no mode argument: a 2^16 NTT
                 and iNTT launch fr_butterfly and no ntt_pass (the
                 config_scan path) and equal staged; "unrolled" raises
  serial         the n = 2^16 SRS (a DeviceSRS), the PLONK index keys and
                 a proof saved and loaded (utils/serialization): a prove
                 from the loaded keys byte-identical, the loaded proof
                 verified on the host; seconds and bytes
  marlin_parity  Marlin at |H| = 2^6: the device proof byte-identical to the
                 port's host Marlin prover's; the scan MSM (K9) and the
                 ladder ran, K7 alone did not
  marlin         Marlin at |H| = 2^14 (m = 2^15): index, two proves, host
                 verification, tamper rejection, phase map, peak memory,
                 launch counts (ntt_pass as on the main path)
  profile        one more steady Marlin |H| = 2^14 prove under torch.profiler:
                 device busy time, idle share, device time by kernel
  bls            BLS12-381 (Fr in 8 words, Fq in the kernels' 12-word
                 instantiation): a random-multiplier basis of 2^16 points
                 (K9, the bls_msm_basis path); every kernel against its
                 plain version on the card, exactly, at Fr and Fq where
                 both are used (fr_pow at 2^16 / 2^14 wide: its plain
                 version takes seconds), with times and bounds; the
                 bucket-route MSM at 2^16 points against the host oracle;
                 the scan-mode NTT (K10, bls_ntt_scan); PLONK n = 2^6
                 byte-identical to the port's host prover (bls_parity; the
                 ladder ran, K7 alone did not);
                 PLONK n = 2^16 (bls_main) as the main phase, with its
                 guards, and the BLS phases' time
  bls_marlin     Marlin on BLS12-381: |H| = 2^6 as marlin_parity
                 (bls_marlin_parity: the ladder and K9 at 12 words), then
                 |H| = 2^14 as the marlin phase
                 (bls_marlin: the bucket MSM and the SRS table at 12
                 words), with launches by width and limb count
  entry          python -m kzg_snark_tpu_torch --synthetic 6 --seed 7
                 --timing on the card, then with KZG_TPU_CHECKED=1: exit
                 0, three PASS lines and the timing report
  dist_nccl      the multi-device path (kzg_snark_tpu_torch/parallel) on
                 one spawned rank over NCCL, BN254: the distributed NTT
                 and iNTT at n = 2^20 equal word for word to the
                 single-device NttContext, the distributed MSM at N =
                 2^20 on random_point_basis equal to the host oracle and
                 the single-device MSM, shards on the scan route, and
                 msm_small at N = 1024 (parallel/dryrun.dryrun_target)
  dist_gloo4     the same checks on four spawned ranks sharing the card
                 over gloo (the four-step's all_to_all, the small fallback
                 at n = 8), the (host=2, chip=2) mesh's msm_multihost at
                 2^20 and two-axis NTT at 2^20, BLS12-381 NTT and MSM at
                 2^16; both dist phases print each rank's device and wall
                 ms a call, the collectives' own ms and bytes,
                 collective_stats, rank 0's launches a call and the
                 single-device ms, and fail unless one transform makes
                 the column plan's ntt_pass launches and log2(D)
                 fr_butterfly launches, or if a kernel of the dist path
                 never launched

The build phase also prints each kernel instantiation's registers, stack
and spills (-Xptxas -v); for the curve kernels (K6, K7, K9 and the
ladder) the resident blocks an SM (the CUDA occupancy calculator) and the
waves 2^16 points make; the instructions of one Montgomery product and
squaring of the PROD_CIOS and PROD_CHAIN policies at 8 and 12 words
(cuobjdump -sass of csrc/probe/mont_probe.cu, by opcode: IMAD-class and
all); those products' throughput on the card (probe_loop), each checked
once against the plain product; and the PROD_CHAIN product's and
squaring's latency on a lone warp (the ladder's floor).  The
kernels and bls phases also hold K6, K7 and K9 to their plain versions
on edge batches (benchpoints.edge_batches: identities, P = Q, P = -Q,
coordinates near p).  Each path (ntt scan, msm_one, msm_prepared and its
splits, main, config_scan, marlin_parity, marlin, the bls paths,
bls_marlin_parity and bls_marlin)
runs with the launch counts set to 0 just before it and read just after;
a kernel's "launches" in the kernels JSON line are those of the path it
is listed under, its "dist_launches" rank 0's launches on the two dist
paths, its "prepared_launches" those of the msm_prepared paths (unsplit,
and the two forced splits together), and its
"bls12_381" entry gives its launches on its BLS12-381 path (also by limb
count) and its rows at BLS12-381; a kernel of OFF_PATH must launch no
time on either.  The second-to-last lines are the kernels JSON and the
nvidia-smi line; the last line is the result JSON.  Any failure raises
(non-zero exit, no result line).  Without a CUDA device the script exits
non-zero at once.

    python3 chip_smoke.py --tree ROOT

times the kernels and paths this slice changed with the package of the
checkout ROOT, a directory inside this one (an earlier commit's `git
archive` unpacked under a gitignored directory), and prints one JSON line
(``tree_times``): K6, K7 and K9 at 2^16 points against their plain
versions and one small MSM (n = 256, k = 1) held to the host oracle on
both curves, device and wall ms, and the launches of the two parity
paths' device runs.  Run it once a tree, in turns on one card (parent,
change, change, parent), to compare two trees.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import subprocess
import sys
import time

# name -> (source, TPU kernel it replaces, the path whose launches count).
KERNELS = {
    "fr_mul": ("kzg_snark_tpu_torch/csrc/fr_kernels.cu",
               "kzg_snark_tpu/ops/pallas_fr.py:114", "main"),
    "fr_add": ("kzg_snark_tpu_torch/csrc/fr_kernels.cu",
               "kzg_snark_tpu/ops/pallas_fr.py:114", "main"),
    "fr_sub": ("kzg_snark_tpu_torch/csrc/fr_kernels.cu",
               "kzg_snark_tpu/ops/pallas_fr.py:114", "main"),
    # K2-K5 (ntt_stage.py:141, :202, :85, :42) in one multi-stage kernel
    "ntt_pass": ("kzg_snark_tpu_torch/csrc/ntt_kernels.cu",
                 "kzg_snark_tpu/ops/ntt_stage.py:141", "main"),
    "g1_add": ("kzg_snark_tpu_torch/csrc/curve_kernels.cu",
               "kzg_snark_tpu/ops/pallas_fr.py:232", "main"),
    # K7 alone: its paths launch it no time since the ladder (OFF_PATH)
    "g1_double": ("kzg_snark_tpu_torch/csrc/curve_kernels.cu",
                  "kzg_snark_tpu/ops/pallas_fr.py:289", "marlin_parity"),
    # K7 (with K6's add) as the small MSM uses it: the ladder in one launch
    "g1_ladder": ("kzg_snark_tpu_torch/csrc/curve_kernels.cu",
                  "kzg_snark_tpu/ops/pallas_fr.py:289", "marlin_parity"),
    # K7 (and K6's row adds) as the SRS table build uses them
    "g1_fixed_base_table": ("kzg_snark_tpu_torch/csrc/srs_kernels.cu",
                            "kzg_snark_tpu/ops/pallas_fr.py:289", "main"),
    "msm_accumulate": ("kzg_snark_tpu_torch/csrc/msm_kernels.cu",
                       "kzg_snark_tpu/ops/msm_kernel.py:172", "main"),
    "msm_reduce": ("kzg_snark_tpu_torch/csrc/msm_kernels.cu",
                   "kzg_snark_tpu/ops/msm_kernel.py:360", "main"),
    "g1_add_mixed": ("kzg_snark_tpu_torch/csrc/curve_kernels.cu",
                     "kzg_snark_tpu/ops/pallas_fr.py:259", "marlin_parity"),
    "fr_butterfly": ("kzg_snark_tpu_torch/csrc/ntt_kernels.cu",
                     "kzg_snark_tpu/ops/pallas_fr.py:158", "ntt_scan"),
    # K1 as the lax.scan chains of kzg_snark_tpu/ops/fr.py:308-445 use it
    "fr_scan": ("kzg_snark_tpu_torch/csrc/fr_scan_kernels.cu",
                "kzg_snark_tpu/ops/pallas_fr.py:114", "main"),
    "fr_pow": ("kzg_snark_tpu_torch/csrc/fr_scan_kernels.cu",
               "kzg_snark_tpu/ops/pallas_fr.py:114", "main"),
}

# Kernels that their paths must launch no time: K7 alone, since the small
# MSM runs the ladder and the scan MSM's Horner fold the bucket route's.
OFF_PATH = ("g1_double",)

MAIN_LOG_N = 16
PARITY_LOG_N = 6
MARLIN_LOG_H = 14
MARLIN_PARITY_LOG_H = 6
MARLIN_PUBLIC = 5
MSM_TABLE_LOG_N = (11, 12, 13, 14, 15, 16, 18)
NTT_TILES_TRIED = (8, 9, 10, 11)
SRS_WINDOW_BITS = 8
SRS_WINDOWS = 32            # ceil(254 / 8): the SRS build's table
TAU = 0xABCDEF12345
EDGE_POINTS = 512           # points of each case in the curve edge batches
LADDER_SIZES = (1, 7, 256)  # points of the ladder checks (256: the small
                            # MSM's most)
LATENCY_REPS = 1024         # dependent products of the lone-warp latency
PLAIN_ONCE_MS = 1000.0      # a plain version this slow is timed by one call
MARLIN_TAU = 0xFEED5EED
ENTRY_ARGS = ["--synthetic", "6", "--seed", "7", "--timing"]

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
L2_BYTES = 50 * 2 ** 20         # H100 L2 cache
INT_MUL_PER_SM_CLK = 64         # 32-bit integer multiply(-add) results per
                                # SM per clock, compute capability 9.0
MONT_PRODUCTS = 2 * 8 * 8 + 8   # 32x32-bit products of one CIOS Montgomery
                                # product over 8 limbs


def mont_products(limbs: int) -> int:
    """32x32-bit products of one CIOS Montgomery product over ``limbs``
    words: 136 at 8, 300 at 12."""
    return 2 * limbs * limbs + limbs


def sqr_products(limbs: int) -> int:
    """32x32-bit products of one Montgomery squaring over ``limbs`` words,
    each cross product once: L (L + 1) / 2 for the square and L^2 + L for
    the reduction, 108 at 8 and 234 at 12."""
    return limbs * (limbs + 1) // 2 + limbs * limbs + limbs


# (squarings, products) of the curve formulas: dbl-2009-l, add-2007-bl (the
# general case of a complete add) and madd-2007-bl; and those on the
# longest dependent path from an operand to the result (the ladder's
# critical path): Y -> B -> C -> D -> Y3 in the doubling, Z2 -> Z2Z2 -> U1
# -> HH -> J -> Y3 in the add.
DOUBLE = (5, 2)
ADD = (5, 11)
MADD = (4, 7)
DOUBLE_DEPTH = (2, 1)
ADD_DEPTH = (2, 3)


def formula_products(limbs: int, ops: tuple) -> int:
    """32x32-bit products of ``ops`` (squarings, products) at ``limbs``
    words."""
    return ops[0] * sqr_products(limbs) + ops[1] * mont_products(limbs)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def device_rates(torch) -> dict:
    """The card's peak rates for the bounds: device memory bytes/s and
    32-bit integer products/s (SMs x 64 a clock x the top SM clock)."""
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"bytes": HBM_BYTES_PER_S,
            "products": sms * INT_MUL_PER_SM_CLK * clock_mhz * 1e6,
            "sms": sms, "clock_mhz": clock_mhz}


def bound(rates: dict, nbytes: float, products: float) -> dict:
    t_bytes = nbytes / rates["bytes"] * 1e3
    t_ops = products / rates["products"] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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


def random_canonical(torch, n: int, seed: int, dev, limbs: int = 8):
    """(limbs, n) int32 limbs of uniform values below 2^253 at 8 limbs
    (under both curves' r and BN254's p) or 2^380 at 12 (under BLS12-381's
    p)."""
    import numpy as np
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(limbs, n),
                                             dtype=np.uint64)
    w[-1] &= (1 << (29 if limbs == 8 else 28)) - 1
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)


def rotated(torch, fn, args):
    """``fn`` over copies of ``args``, a different copy each call, enough
    of them that one round reads at least twice the L2 cache: a timed call
    finds its inputs in device memory, as a prover's call does, and not in
    the L2 where the previous call left them."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if torch.is_tensor(a))
    copies = min(64, max(1, -(-2 * L2_BYTES // max(nbytes, 1))))
    sets = [args] + [tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args) for _ in range(copies - 1)]
    turn = itertools.cycle(sets)
    return lambda: fn(*next(turn))


def compare(torch, name, results, kernel_fn, plain_fn, args, work, reps=20,
            plain_reps=3):
    """Run kernel and plain version on the same CUDA inputs ``args``;
    demand exact equality; record both times (inputs rotated through
    copies, see ``rotated``; ``plain_reps = 0``, or a compared plain call
    of a second or more: the plain version's time is that of the one call
    compared, host clock to a sync) and the bound of ``work`` (a dict
    from ``bound``)."""
    got = kernel_fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain_fn(*args)
    torch.cuda.synchronize()
    plain_once = (time.perf_counter() - t0) * 1e3
    if plain_once >= PLAIN_ONCE_MS:
        plain_reps = 0
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain (max |diff| {err})")
    dev_ms, wall = timed_ms(torch, rotated(torch, kernel_fn, args), reps)
    plain_dev, plain_wall = timed_ms(
        torch, rotated(torch, plain_fn, args), plain_reps) if plain_reps \
        else (plain_once, plain_once)
    # A call costs its device time unless the host cannot keep up; the
    # plain versions' thousands of small launches overflow the queue.
    results[name] = {"max_abs_err": err, "ms": min(dev_ms, wall),
                     "plain_ms": min(plain_dev, plain_wall), **work,
                     "library_ms": None}
    log(f"[kernels] {name}: exact, device ms: kernel {dev_ms:.4f}, plain "
        f"{plain_dev:.4f}; wall ms per call: kernel {wall:.4f}, plain "
        f"{plain_wall:.4f}; bound {work['bound_ms']:.4f} ms "
        f"({work['bound_by']}); shape {tuple(got.shape)}")


def ntt_bound(rates: dict, n: int) -> dict:
    """Bound of a transform of n: k n / 2 Montgomery products; the (8, n)
    array read and written once and the (8, n/2) table read once."""
    k = n.bit_length() - 1
    return bound(rates, 32 * n * 2 + 32 * n // 2, MONT_PRODUCTS * k * n // 2)


def table_bound(rates: dict, c: int, windows: int, limbs: int = 8) -> dict:
    """Bound of the fixed-base table (c, W): the base read, W 2^c points
    written (12 limbs bytes a point); the products its data needs: a
    doubling (c (W - 1) in the chain, W a level), an add except the W a
    level whose left operand is the identity (the case split finds no
    equal or opposite pair: v < count)."""
    levels = c - 1
    doublings = c * (windows - 1) + windows * levels
    adds = windows * ((1 << c) - 2) - windows * levels
    pt = 12 * limbs
    return bound(rates, pt + pt * windows * (1 << c),
                 formula_products(limbs, DOUBLE) * doublings
                 + formula_products(limbs, ADD) * adds)


def curve_base(torch, dev, curve="bn254"):
    """The curve's G1 generator as a (3, L, 1) Jacobian batch."""
    from kzg_snark_tpu_torch.ops.g1 import curve_ops, generator
    gx, gy = generator(curve)
    return curve_ops(curve, dev).from_affine_ints([gx], [gy]).contiguous()


def _add_products(torch, fq, p, q) -> float:
    """32-bit products K6 does on these inputs: none with an identity
    operand, 2 squarings and 6 products before the case split, 3 and 5 more
    in the general case or a doubling where p == q."""
    from kzg_snark_tpu_torch.ops import cuda_fr
    f = cuda_fr.PlainField(fq)
    z1z1, z2z2 = f.square(p[2]), f.square(q[2])
    h = f.sub(f.mul(q[0], z1z1), f.mul(p[0], z2z2))
    r = f.sub(f.mul(f.mul(q[1], p[2]), z1z1), f.mul(f.mul(p[1], q[2]), z2z2))
    finite = ~f.is_zero(p[2]) & ~f.is_zero(q[2])
    h0, r0 = f.is_zero(h), f.is_zero(r)
    L = fq.num_limbs
    per = (formula_products(L, (2, 6)) * finite
           + formula_products(L, (3, 5)) * (finite & ~h0)
           + formula_products(L, DOUBLE) * (finite & h0 & r0))
    return float(per.sum())


def _madd_products(torch, fq, p, qx, qy) -> float:
    """32-bit products K9 does: none where p is the identity, madd-2007-bl,
    and a doubling more where p == q."""
    from kzg_snark_tpu_torch.ops import cuda_fr
    f = cuda_fr.PlainField(fq)
    reps = p.shape[-1] // qx.shape[-1]
    qx, qy = qx.repeat(1, reps), qy.repeat(1, reps)
    z1z1 = f.square(p[2])
    h = f.sub(f.mul(qx, z1z1), p[0])
    r = f.sub(f.mul(f.mul(qy, p[2]), z1z1), p[1])
    finite = ~f.is_zero(p[2])
    L = fq.num_limbs
    per = (formula_products(L, MADD) * finite
           + formula_products(L, DOUBLE)
           * (finite & f.is_zero(h) & f.is_zero(r)))
    return float(per.sum())


def curve_occupancy(torch, resources: dict, rates: dict) -> None:
    """The curve kernels' registers and spills (-Xptxas -v), their resident
    blocks an SM (the CUDA occupancy calculator) and the waves that 2^16
    points make: K6, K7 and K9 (the carry-chain product); the ladder's
    registers and spills (summed: true, per point: false), and the summed
    form's blocks of 256 threads an SM."""
    from kzg_snark_tpu_torch.utils.build import cuda_lib
    lib = cuda_lib()
    threads = lib.kzg_g1_threads()
    blocks = -(-(1 << MAIN_LOG_N) // threads)
    for idx, kernel in enumerate(("k_g1_add", "k_g1_add_mixed",
                                  "k_g1_double")):
        for limbs in (8, 12):
            res = next(v for k, v in resources.items()
                       if f"{kernel}<{limbs}>" in k      # demangled
                       or f"{len(kernel)}{kernel}ILi{limbs}E" in k)
            per_sm = lib.kzg_g1_blocks_per_sm(idx, limbs)
            if per_sm <= 0:
                raise RuntimeError(f"occupancy of {kernel}<{limbs}>: "
                                   f"{per_sm}")
            resident = per_sm * rates["sms"]
            log(f"[build] {kernel}<{limbs}>: {res['registers']} registers, "
                f"spills {res['spill_stores']} B st / {res['spill_loads']} "
                f"B ld; {per_sm} blocks of {threads} an SM, {resident} "
                f"resident; 2^{MAIN_LOG_N} points = {blocks} blocks = "
                f"{blocks / resident:.2f} waves ({-(-blocks // resident)})")
    kernel = "k_g1_ladder"
    for limbs in (8, 12):
        for tree in ("true", "false"):
            res = next(v for k, v in resources.items()
                       if f"{kernel}<{limbs}, {tree}>" in k
                       or f"{len(kernel)}{kernel}ILi{limbs}ELb"
                          f"{int(tree == 'true')}E" in k)
            log(f"[build] {kernel}<{limbs}, {tree}>: {res['registers']} "
                f"registers, spills {res['spill_stores']} B st / "
                f"{res['spill_loads']} B ld" + (
                    f"; {lib.kzg_g1_blocks_per_sm(3, limbs)} block of 256 "
                    f"threads an SM" if tree == "true" else ""))


def product_sass(lib_path: str) -> None:
    """Instructions of one Montgomery product and squaring, PROD_CIOS and
    PROD_CHAIN, at 8 and 12 words (cuobjdump -sass of a probe)."""
    import shutil
    from kzg_snark_tpu_torch.utils.build import _nvcc, sass_product_counts
    if not (shutil.which("cuobjdump") or os.path.exists(os.path.join(
            os.path.dirname(_nvcc()), "cuobjdump"))):
        log("[build] product SASS: cuobjdump not in the toolkit")
        return
    for key, c in sorted(sass_product_counts(lib_path).items()):
        log(f"[build] product SASS {key} words: {json.dumps(c)}")


PRODUCT_LOOP_N = 1 << 17      # elements of the product throughput loops
PRODUCT_LOOP_REPS = 64        # dependent products an element


def product_throughput(torch, dev, rates: dict) -> None:
    """The Montgomery product and squaring of PROD_CIOS and PROD_CHAIN at 8
    words (BN254 Fq) and 12 (BLS12-381 Fq): one product each against the
    plain version, then Montgomery products a second over PRODUCT_LOOP_N
    elements of PRODUCT_LOOP_REPS dependent products (probe_loop, device
    time), beside the 32 x 32-bit product bound of the kernel table."""
    from kzg_snark_tpu_torch.ops import cuda_fr
    from kzg_snark_tpu_torch.ops.fr import fq_backend
    from kzg_snark_tpu_torch.utils.build import check, probe_lib
    lib = probe_lib()
    n, reps = PRODUCT_LOOP_N, PRODUCT_LOOP_REPS
    stream = torch.cuda.current_stream(dev).cuda_stream
    for curve, limbs in (("bn254", 8), ("bls12_381", 12)):
        fc = fq_backend(curve, dev).consts
        x = random_canonical(torch, n, 71, dev, limbs)
        y = random_canonical(torch, n, 72, dev, limbs)
        out = torch.empty_like(x)
        for sqr, pol, name in ((0, 0, "mul cios"), (0, 2, "mul chain"),
                               (1, 0, "sqr cios"), (1, 2, "sqr chain")):
            def run(r, sqr=sqr, pol=pol):
                check(lib.kzg_probe_loop(sqr, pol, x.data_ptr(),
                                         y.data_ptr(), out.data_ptr(), n, r,
                                         fc.ptr, stream), "probe_loop")
            run(1)
            want = cuda_fr.mul_plain(fc, x, x if sqr else y)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"probe {name} at {limbs} words != "
                                     f"plain")
            ms, _ = timed_ms(torch, lambda: run(reps), 5)
            per_s = n * reps / (ms * 1e-3)
            peak = rates["products"] / mont_products(limbs)
            log(f"[build] product loop {name} {limbs} words: {ms:.4f} ms "
                f"for {n} x {reps}: {per_s / 1e9:.2f} G Montgomery "
                f"products/s, {per_s / peak:.1%} of the 32x32-bit product "
                f"bound ({mont_products(limbs)} a product)")


LATENCY: dict = {}     # limbs -> {"mul": us, "sqr": us} on a lone warp


def product_latency(torch, dev) -> None:
    """One PROD_CHAIN Montgomery product's and squaring's latency on a lone
    warp, at 8 and 12 words: probe_loop over 32 elements (one warp) of
    LATENCY_REPS dependent products, device time over the count, into
    LATENCY (the ladder's floor and serial cost)."""
    from kzg_snark_tpu_torch.ops.fr import fq_backend
    from kzg_snark_tpu_torch.utils.build import check, probe_lib
    lib = probe_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for curve, limbs in (("bn254", 8), ("bls12_381", 12)):
        fc = fq_backend(curve, dev).consts
        x = random_canonical(torch, 32, 73, dev, limbs)
        y = random_canonical(torch, 32, 74, dev, limbs)
        out = torch.empty_like(x)
        for sqr, name in ((0, "mul"), (1, "sqr")):
            def run(sqr=sqr):
                check(lib.kzg_probe_loop(sqr, 2, x.data_ptr(), y.data_ptr(),
                                         out.data_ptr(), 32, LATENCY_REPS,
                                         fc.ptr, stream), "probe_loop")
            ms, _ = timed_ms(torch, run, 5)
            LATENCY.setdefault(limbs, {})[name] = ms * 1e3 / LATENCY_REPS
        log(f"[build] PROD_CHAIN latency on a lone warp, {limbs} words: "
            f"product {LATENCY[limbs]['mul']:.4f} us, squaring "
            f"{LATENCY[limbs]['sqr']:.4f} us ({LATENCY_REPS} dependent, "
            f"32 elements)")


def check_edge_batches(torch, fq, curve: str, pts) -> None:
    """K6, K7 and K9 against their plain versions, exactly, on the edge
    batches of ``benchpoints.edge_batches`` from EDGE_POINTS points:
    identity operands, P = Q, P = -Q, q with column periods m and 1,
    coordinates near p and all-ones words (K7: the add's p and q)."""
    from kzg_snark_tpu_torch.ops import cuda_fr
    from kzg_snark_tpu_torch.ops.benchpoints import edge_batches
    cases = edge_batches(curve, pts[..., :EDGE_POINTS].contiguous())
    p, q = cases["add"]
    pq = torch.cat([p, q], dim=-1).contiguous()
    runs = [("g1_add", cuda_fr.g1_add(fq, p, q),
             cuda_fr.g1_add_plain(fq, p, q)),
            ("g1_double", cuda_fr.g1_double(fq, pq),
             cuda_fr.g1_double_plain(fq, pq))]
    for acc, qx, qy in cases["mixed"]:
        runs.append((f"g1_add_mixed (qn = {qx.shape[-1]})",
                     cuda_fr.g1_add_mixed(fq, acc, qx, qy),
                     cuda_fr.g1_add_mixed_plain(fq, acc, qx, qy)))
    torch.cuda.synchronize()
    for name, got, want in runs:
        if not torch.equal(got, want):
            raise AssertionError(f"{curve} {name}: kernel != plain on the "
                                 f"edge batch")
        log(f"[kernels] {curve} {name}: exact on an edge batch of "
            f"{got.shape[-1]} points")


def ladder_work(rates: dict, sets: list, limbs: int) -> dict:
    """Bound, floor and serial cost of one summed ladder (``g1_ladder``)
    over the scalar sets ``sets`` (lists of n ints, one a point).

    Bound: bytes, the points, the scalar words and the results, once;
    products on this data, a doubling for each row below a point's highest
    set bit over the sets, a complete add for each add after a (set,
    point)'s first (which meets the identity and copies) and for each of a
    set's n - 1 tree adds.

    Floor (``floor_ms``): the critical path at the lone-warp latencies of
    LATENCY.  A row's add and doubling are independent, so a thread's
    longest path climbs the doublings to one of its set bits and then runs
    through the adds of the set bits from there on (DOUBLE_DEPTH and
    ADD_DEPTH each); then the tree, an add's depth a level where both
    operands are points (a partial sum that cancels to the identity is
    counted as a point).

    Serial (``serial_ms``): every product of a warp's rows, up to the
    highest set bit of the run's scalars, one after another at those
    latencies, each row a complete add (a warp pays it unless every lane's
    bit is 0) and, but the last, a doubling, then ceil(log2 n) tree adds:
    one thread's stream of products, what a design of one thread a (set,
    point) pays."""
    k, n = len(sets), len(sets[0])
    tops = [[s.bit_length() - 1 for s in row] for row in sets]
    adds = [[max(bin(s).count("1") - 1, 0) for s in row] for row in sets]
    dbl = sum(max(max(t[i] for t in tops), 0) for i in range(n))
    work = bound(rates, 12 * limbs * n + 32 * k * n + 12 * limbs * k,
                 formula_products(limbs, DOUBLE) * dbl
                 + formula_products(limbs, ADD)
                 * (sum(map(sum, adds)) + k * (n - 1)))
    lat = LATENCY[limbs]

    def us(ops):
        return ops[0] * lat["sqr"] + ops[1] * lat["mul"]

    d_dbl, d_add = us(DOUBLE_DEPTH), us(ADD_DEPTH)
    floor = 0.0
    for row in sets:
        nodes = []          # (ready time, is the identity)
        for s in row:
            bits = [b for b in range(s.bit_length()) if s >> b & 1]
            nodes.append((max((b * d_dbl + (len(bits) - j - (j == 0)) * d_add
                               for j, b in enumerate(bits)), default=0.0),
                          not bits))
        m = n
        while m > 1:
            h = (m + 1) // 2
            pairs = [(nodes[i], nodes[i + h] if i + h < m else (0.0, True))
                     for i in range(h)]
            nodes = [(max(a[0], b[0]) + (0 if a[1] or b[1] else d_add),
                      a[1] and b[1]) for a, b in pairs]
            m = h
        floor = max(floor, nodes[0][0])
    rows = max(map(max, tops)) + 1
    serial = (max(rows - 1, 0) * us(DOUBLE)
              + (rows + (n - 1).bit_length()) * us(ADD))
    work["floor_ms"] = floor / 1e3
    work["serial_ms"] = serial / 1e3
    work["rows"] = rows
    return work


def check_ladder(torch, fq, curve: str, pts, ks, rates, results,
                 name="g1_ladder") -> None:
    """g1_ladder against g1_ladder_plain, exactly: at n in LADDER_SIZES with
    k = 3 and 1 sets of ``edge_scalar_sets`` (random; 0, 1, r - 1 and a
    duplicate; a set summing to the identity), one scalar of column period
    1 summed and per point, and scale_const by r - 1, the plain version on
    CPU copies of the inputs (its Python-integer path; on the card each of
    its 256 rows is hundreds of small launches).  Then one small MSM's
    kernel (n = 256, k = 1, random scalars) against the plain version on
    the card, timed (``compare``), its bound, floor and serial cost
    (``ladder_work``) into ``results[name]``."""
    from kzg_snark_tpu_torch import constants as C
    from kzg_snark_tpu_torch.ops import cuda_fr
    from kzg_snark_tpu_torch.ops.benchpoints import edge_scalar_sets
    from kzg_snark_tpu_torch.ops.g1 import curve_ops
    from kzg_snark_tpu_torch.ops.limbs import ints_to_words, to_tensor

    dev = pts.device
    L = fq.num_limbs
    for n in LADDER_SIZES:
        p = pts[..., :n].contiguous()
        sc = torch.stack([to_tensor(ints_to_words(s), dev)
                          for s in edge_scalar_sets(curve, ks[:n], 80 + n)])
        got, got1 = (cuda_fr.g1_ladder(fq, p, x) for x in
                     (sc, sc[:1].contiguous()))
        want = cuda_fr.g1_ladder_plain(fq, p.cpu(), sc.cpu())
        if not (torch.equal(got.cpu(), want)
                and torch.equal(got1.cpu(), want[..., :1])):
            raise AssertionError(f"{curve} g1_ladder != plain at n = {n}")
        if n != 7:
            continue
        one = sc[:1, :, 1:2].contiguous()
        for tree in (True, False):
            if not torch.equal(cuda_fr.g1_ladder(fq, p, one, tree).cpu(),
                               cuda_fr.g1_ladder_plain(fq, p.cpu(), one.cpu(),
                                                       tree)):
                raise AssertionError(f"{curve} g1_ladder (one scalar, tree "
                                     f"{tree}) != plain")
    r = C.BN254_R if curve == "bn254" else C.BLS12_381_R
    few = pts[..., :16].contiguous()
    rm1 = to_tensor(ints_to_words([r - 1]), "cpu")[None]
    if not torch.equal(curve_ops(curve, dev).scale_const(few, r - 1).cpu(),
                       cuda_fr.g1_ladder_plain(fq, few.cpu(), rm1,
                                               False)[:, :, 0]):
        raise AssertionError(f"{curve} scale_const(r - 1) != plain")
    log(f"[kernels] {curve} g1_ladder == plain at n = {LADDER_SIZES}, k = 3 "
        f"and 1 (edge scalar sets), one scalar of period 1 summed and per "
        f"point; scale_const(r - 1) == plain")

    import random
    rng = random.Random(90)
    n = LADDER_SIZES[-1]
    ints = [[rng.randrange(r) for _ in range(n)]]
    sc = to_tensor(ints_to_words(ints[0]), dev)[None]
    p = pts[..., :n].contiguous()
    work = ladder_work(rates, ints, L)
    compare(torch, name, results,
            lambda u, v: cuda_fr.g1_ladder(fq, u, v),
            lambda u, v: cuda_fr.g1_ladder_plain(fq, u, v), (p, sc), work,
            reps=10, plain_reps=0)
    log(f"[kernels] {curve} g1_ladder, one small MSM (n = {n}, k = 1, "
        f"{L} words): {work['rows']} rows; bound {work['bound_ms']:.4f} ms "
        f"({work['bound_by']}), critical-path floor {work['floor_ms']:.4f} "
        f"ms, one thread's products in turn {work['serial_ms']:.4f} ms")


def curve_rows(torch, rates, fq_be, pts, row) -> None:
    """K6, K7 and K9 at the paths' shape over the m points ``pts`` (3, L,
    m), each through ``row(name, kernel_fn, plain_fn, args, work)``: K6
    pts + q and K7 2 q, where q is pts rotated and doubled and its first
    lanes hold equal, opposite and identity cases; K9 at the basis build's
    shape, one affine q broadcast over m accumulators whose first lanes are
    the identity, q and -q.  Bounds from the products these inputs need."""
    from kzg_snark_tpu_torch.ops import cuda_fr
    fq = fq_be.consts
    L, m = pts.shape[1], pts.shape[2]
    k = 64          # equal, opposite and identity cases in the first lanes
    q = cuda_fr.g1_double(fq, pts.roll(1, -1).contiguous())
    q[:, :, :2 * k] = pts[:, :, :2 * k]
    q[1, :, k:2 * k] = fq_be.neg(pts[1, :, k:2 * k].contiguous())
    q[2, :, 2 * k:3 * k] = 0
    q = q.contiguous()
    qx = pts[0, :, 7:8].contiguous()
    qy = pts[1, :, 7:8].contiguous()
    acc = q.clone()
    acc[2, :, :k] = 0
    acc[0, :, k:2 * k] = qx
    acc[1, :, k:2 * k] = qy
    acc[2, :, k:3 * k] = fq_be.one_mont
    acc[0, :, 2 * k:3 * k] = qx
    acc[1, :, 2 * k:3 * k] = fq_be.neg(qy)
    acc = acc.contiguous()
    pt_bytes = 12 * L * m
    row("g1_add", lambda u, v: cuda_fr.g1_add(fq, u, v),
        lambda u, v: cuda_fr.g1_add_plain(fq, u, v), (pts, q),
        bound(rates, 3 * pt_bytes, _add_products(torch, fq, pts, q)))
    row("g1_double", lambda u: cuda_fr.g1_double(fq, u),
        lambda u: cuda_fr.g1_double_plain(fq, u), (q,),
        bound(rates, 2 * pt_bytes, formula_products(L, DOUBLE) * m))
    row("g1_add_mixed", lambda u, x, y: cuda_fr.g1_add_mixed(fq, u, x, y),
        lambda u, x, y: cuda_fr.g1_add_mixed_plain(fq, u, x, y),
        (acc, qx, qy), bound(rates, 2 * pt_bytes + 8 * L,
                             _madd_products(torch, fq, acc, qx, qy)))


def phase_kernels(torch, dev, results, rates):
    from kzg_snark_tpu_torch.ops import cuda_fr
    from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
    from kzg_snark_tpu_torch.ops.fr import fq_backend, fr_backend
    from kzg_snark_tpu_torch.ops import msm_kernel as mk
    from kzg_snark_tpu_torch.ops.ntt import ntt_context
    from kzg_snark_tpu_torch.ops.ntt_stage import (butterfly_plain,
                                                   fr_butterfly,
                                                   ntt_pass_plain,
                                                   staged_transform)
    from kzg_snark_tpu_torch.ops.srs import (fixed_base_table_plain,
                                             g1_fixed_base_table)

    fr = fr_backend("bn254", dev).consts
    fq = fq_backend("bn254", dev).consts
    n_field = 1 << (MAIN_LOG_N + 2)
    a = random_canonical(torch, n_field, 1, dev)
    b = random_canonical(torch, n_field, 2, dev)
    elem = 32 * n_field
    for name, k, p, prods in [
            ("fr_mul", cuda_fr.fr_mul, cuda_fr.mul_plain, MONT_PRODUCTS),
            ("fr_add", cuda_fr.fr_add, cuda_fr.add_plain, 0),
            ("fr_sub", cuda_fr.fr_sub, cuda_fr.sub_plain, 0)]:
        compare(torch, name, results, lambda x, y, k=k: k(fr, x, y),
                lambda x, y, p=p: p(fr, x, y), (a, b),
                bound(rates, 3 * elem, prods * n_field))
    s = b[:, :1].contiguous()
    compare(torch, "fr_mul_scalar", {}, lambda x, y: cuda_fr.fr_mul(fr, x, y),
            lambda x, y: cuda_fr.mul_plain(fr, x, y), (a, s),
            bound(rates, 2 * elem + 32, MONT_PRODUCTS * n_field))

    npts = 1 << MAIN_LOG_N
    pts, ks = random_point_basis("bn254", npts, seed=5, device=dev)
    curve_rows(torch, rates, fq_backend("bn254", dev), pts,
               lambda name, *a: compare(torch, name, results, *a,
                                        plain_reps=1))
    check_edge_batches(torch, fq, "bn254", pts)
    check_ladder(torch, fq, "bn254", pts, ks, rates, results)

    # ntt_pass as the paths run it: one whole 2^18 transform (its passes),
    # against the plain stages; products k n / 2 x 136, bytes the array in
    # and out and the (8, n/2) twiddle table.
    ctx = ntt_context("bn254", n_field, dev)
    log_n = n_field.bit_length() - 1
    compare(torch, "ntt_pass", results,
            lambda u, tw: staged_transform(fr, u, tw),
            lambda u, tw: ntt_pass_plain(fr, u, tw, 0, log_n),
            (a, ctx.tw_fwd), ntt_bound(rates, n_field), reps=10,
            plain_reps=1)

    # The SRS build's table, c = 8, W = 32, of the generator.
    base = curve_base(torch, dev)
    compare(torch, "g1_fixed_base_table", results,
            lambda u: g1_fixed_base_table(fq, u, SRS_WINDOW_BITS,
                                          SRS_WINDOWS),
            lambda u: fixed_base_table_plain(fq, u, SRS_WINDOW_BITS,
                                             SRS_WINDOWS),
            (base,), table_bound(rates, SRS_WINDOW_BITS, SRS_WINDOWS),
            reps=5, plain_reps=1)

    import numpy as np
    mask = torch.from_numpy(np.random.default_rng(4).integers(
        0, 2, n_field).astype(np.int32)).to(dev)
    tw = random_canonical(torch, n_field, 6, dev)
    compare(torch, "fr_butterfly", results,
            lambda u, v, w, m: fr_butterfly(fr, u, v, w, m),
            lambda u, v, w, m: butterfly_plain(fr, u, v, w, m),
            (a, b, tw, mask),
            bound(rates, 4 * elem + 4 * n_field, MONT_PRODUCTS * n_field))

    # The bucket route at the main paths' shape: 2^16 points, one set of
    # random scalars (c from window_bits), then the complete add and a
    # skewed batch.
    xy = mk.point_table(pts)
    sched, W, c = bucket_schedule(torch, random_canonical(torch, npts, 3, dev)
                                  [None])
    compare(torch, "msm_accumulate", results,
            lambda u, e, o: mk.msm_accumulate(fq, u, e, o, False),
            lambda u, e, o: mk.msm_accumulate_plain(fq, u, e, o, False),
            (xy, sched.entries, sched.chunk_off),
            bound(rates, *accumulate_work(npts, sched)), reps=10,
            plain_reps=1)
    part = mk.msm_accumulate(fq, xy, sched.entries, sched.chunk_off, False)
    compare(torch, "msm_reduce", results,
            lambda u, bc: mk.msm_reduce(fq, u, bc, 1, W, c,
                                        sched.window_threads),
            lambda u, bc: mk.msm_reduce_plain(fq, u, bc, 1, W, c,
                                              sched.window_threads),
            (part, sched.bucket_chunks),
            bound(rates, *reduce_work(sched, 1, W, c)), reps=10,
            plain_reps=1)
    m = 4096
    skew = random_canonical(torch, m, 8, dev)
    skew = torch.stack([skew, skew[:, :1].expand(8, m).contiguous()])
    s4, W4, c4 = bucket_schedule(torch, skew)
    xy4 = xy[:m].contiguous()
    compare(torch, "msm_accumulate_complete_4096", {},
            lambda u, e, o: mk.msm_accumulate(fq, u, e, o, True),
            lambda u, e, o: mk.msm_accumulate_plain(fq, u, e, o, True),
            (xy4, s4.entries, s4.chunk_off),
            bound(rates, *accumulate_work(m, s4)), reps=3, plain_reps=1)
    part4 = mk.msm_accumulate(fq, xy4, s4.entries, s4.chunk_off, True)
    compare(torch, "msm_reduce_skewed_k2_4096", {},
            lambda u, bc: mk.msm_reduce(fq, u, bc, 2, W4, c4,
                                        s4.window_threads),
            lambda u, bc: mk.msm_reduce_plain(fq, u, bc, 2, W4, c4,
                                              s4.window_threads),
            (part4, s4.bucket_chunks),
            bound(rates, *reduce_work(s4, 2, W4, c4)), reps=3, plain_reps=1)


def phase_chains(torch, dev, results, rates):
    """fr_scan and fr_pow (K1 as the provers' chains use it) against their
    plain versions, exactly: fr_scan at the edge widths, both operations,
    both directions, the total alone, a column read with step 0; fr_pow at
    widths 1, 256 and 2^18 with e in {0, 1, 2, 2^16, r - 2} and p - 2 under
    Fq.  The sums and powers take zero entries; the products none, since a
    zero forces every later prefix to zero and would leave the tiles after
    it unchecked.  Then the two rows (kernel, plain and bound), the times
    at the paths' widths, and the device time of one narrow K1 and K7
    launch."""
    from kzg_snark_tpu_torch import constants as C
    from kzg_snark_tpu_torch.ops import cuda_fr, scan
    from kzg_snark_tpu_torch.ops.fr import fq_backend, fr_backend
    from kzg_snark_tpu_torch.ops.limbs import ints_to_words, to_tensor

    fr = fr_backend("bn254", dev).consts
    fq = fq_backend("bn254", dev).consts
    r, p = C.BN254_R, C.BN254_P
    n = 1 << MAIN_LOG_N
    n_big = (1 << (MAIN_LOG_N + 2)) + 3
    am = random_canonical(torch, n_big, 30, dev)      # no zero column
    am[:, 1::997] = to_tensor(ints_to_words([r - 1]), dev)
    if not bool(am.ne(0).any(dim=0).all()):
        raise AssertionError("the product scans' input holds a zero")
    a = am.clone()
    a[:, ::997] = 0
    tile = scan.tile()
    widths = (1, 2, tile - 1, tile, tile + 1, n, n_big)
    for m in widths:
        for op, src in ((scan.MUL, am), (scan.ADD, a)):
            x = src[:, :m]             # a column slice: rows n_big apart
            for reverse in (False, True):
                want, want_total = scan.fr_scan_plain(fr, x, op, reverse)
                got, total = scan.fr_scan(fr, x, op, reverse)
                _, alone = scan.fr_scan(fr, x, op, reverse, want_scan=False)
                if not (torch.equal(got, want)
                        and torch.equal(total, want_total)
                        and torch.equal(alone, want_total)):
                    raise AssertionError(
                        f"fr_scan differs from plain at n = {m}, op {op}, "
                        f"reverse {reverse}")
    z = a[:, 2:3]
    for op in (scan.MUL, scan.ADD):
        rep = z.expand(8, n)
        if not torch.equal(scan.fr_scan(fr, rep, op)[0],
                           scan.fr_scan_plain(fr, rep, op)[0]):
            raise AssertionError("fr_scan of a repeated column differs")
    log(f"[chains] fr_scan == plain at n = {widths} (columns of an (8, "
        f"{n_big}) array), product (no zero) and sum (zeros), forward and "
        f"reverse, with the total alone, and a column repeated "
        f"2^{MAIN_LOG_N} times (step 0)")

    for fc, exps in ((fr, (0, 1, 2, 1 << 16, r - 2)), (fq, (p - 2,))):
        for m, off in ((1, 0), (1, 2), (256, 0), (1 << (MAIN_LOG_N + 2), 0)):
            x = a[:, off:off + m].contiguous()
            for e in exps:
                want = scan.fr_pow_plain(fc, x, e)
                if not torch.equal(scan.fr_pow(fc, x, e), want):
                    raise AssertionError(
                        f"fr_pow differs from plain at width {m}, e = {e}")
    log("[chains] fr_pow == plain at widths 1 (a zero and a nonzero), 256 "
        "and 2^18, e in {0, 1, 2, 2^16, r - 2} under Fr and p - 2 under Fq")

    cat = lambda pair: torch.cat(pair, dim=1)                  # noqa: E731
    xs = am[:, :n].contiguous()
    compare(torch, "fr_scan", results,
            lambda u: cat(scan.fr_scan(fr, u, scan.MUL)),
            lambda u: cat(scan.fr_scan_plain(fr, u, scan.MUL)), (xs,),
            bound(rates, 64 * n + 32, MONT_PRODUCTS * (n - 1)))
    e = r - 2
    steps = e.bit_length() - 1 + bin(e).count("1")
    w18 = 1 << (MAIN_LOG_N + 2)
    x18 = a[:, :w18].contiguous()
    compare(torch, "fr_pow", results, lambda u: scan.fr_pow(fr, u, e),
            lambda u: scan.fr_pow_plain(fr, u, e), (x18,),
            bound(rates, 64 * w18, MONT_PRODUCTS * steps * w18), reps=5,
            plain_reps=1)

    def dev_ms(fn, *args, reps=20):
        return timed_ms(torch, rotated(torch, fn, args), reps)[0]

    row = []
    for m in (n, n_big):
        for op, name, src in ((scan.MUL, "product", am), (scan.ADD, "sum", a)):
            row.append(f"n = {m} {name}: " + "%.4f" % dev_ms(
                lambda u: scan.fr_scan(fr, u, op), src[:, :m].contiguous()))
        row.append(f"n = {m} sum, total alone: %.4f" % dev_ms(
            lambda u: scan.fr_scan(fr, u, scan.ADD, want_scan=False),
            a[:, :m].contiguous()))
    log("[chains] fr_scan device ms: " + "; ".join(row))
    row = []
    for m in (1, 256, w18):
        x = a[:, 2:2 + m].contiguous()
        row.append(f"width {m}: " + "%.4f" % dev_ms(
            lambda u: scan.fr_pow(fr, u, e), x, reps=5 if m == w18 else 20))
    log(f"[chains] fr_pow (e = r - 2, {steps} products a chain) device ms: "
        + "; ".join(row))
    pts = torch.stack([a[:, 3:4], a[:, 4:5], a[:, 5:6]]).contiguous()
    log("[chains] one narrow launch, device ms: fr_mul (8, 1) %.4f, "
        "(8, 256) %.4f; g1_double of 1 point %.4f" % (
            dev_ms(lambda u: cuda_fr.fr_mul(fr, u, u), a[:, :1].contiguous()),
            dev_ms(lambda u: cuda_fr.fr_mul(fr, u, u),
                   a[:, :256].contiguous()),
            dev_ms(lambda u: cuda_fr.g1_double(fq, u), pts)))

    # The SRS table kernel with W = 2, 9 and 32 windows of c = 8: its
    # one-thread chain is c (W - 1) = 8, 64 and 248 doublings; its levels
    # grow with W too (W doublings and W (2^c - 2) adds over 512 threads).
    from kzg_snark_tpu_torch.ops.srs import (fixed_base_table_plain,
                                             g1_fixed_base_table)
    base = curve_base(torch, dev)
    c = SRS_WINDOW_BITS
    chain_ms = {}
    for w in (2, 9, SRS_WINDOWS):
        if not torch.equal(g1_fixed_base_table(fq, base, c, w),
                           fixed_base_table_plain(fq, base, c, w)):
            raise AssertionError(f"g1_fixed_base_table differs from plain "
                                 f"at c = {c}, W = {w}")
        chain_ms[c * (w - 1)] = dev_ms(
            lambda u, w=w: g1_fixed_base_table(fq, u, c, w), base, reps=5)
    lo, hi = min(chain_ms), max(chain_ms)
    log("[chains] g1_fixed_base_table (c = 8) == plain at W = 2, 9, 32; "
        "device ms by chain length: " + "; ".join(
            f"{d} doublings (W = {d // c + 1}): {ms:.4f}"
            for d, ms in sorted(chain_ms.items()))
        + f"; slope {(chain_ms[hi] - chain_ms[lo]) / (hi - lo) * 1e3:.3f} "
        f"us a doubling ({lo}..{hi}, levels included)")


def bucket_schedule(torch, sets, c=None, chunk=None, events=None, bits=254):
    """Scalar sets (k, 8, n) of ``bits`` bits -> (schedule, W, c) of the
    bucket route."""
    from kzg_snark_tpu_torch.ops import msm_kernel as mk
    c = c or mk.window_bits(sets.shape[-1])
    dig = mk.signed_digits(sets, bits, c)
    sched = mk.bucket_schedule(dig, c, chunk or mk.CHUNK,
                               events or mk.EVENTS_PER_THREAD)
    return sched, dig.shape[1], c


def accumulate_work(n, sched, limbs=8):
    """(bytes, 32-bit products) of the accumulate: the points read once,
    the entries and offsets, the partials written; a mixed add per entry
    after a chunk's first."""
    E = sched.entries.numel()
    C = sched.chunk_off.numel() - 1
    return (8 * limbs * n + 4 * E + 4 * (C + 1) + 12 * limbs * C,
            (E - C) * formula_products(limbs, MADD))


def reduce_work(sched, sets, W, c, limbs=8):
    """(bytes, products) of the reduction this data needs: one complete add
    a chunk partial (bucket sums and running sums) and a step (Wt += R)
    for each magnitude up to a window's top nonempty bucket; the Horner
    fold's c (W - 1) doublings and W adds."""
    import torch
    C = sched.chunk_off.numel() - 1
    half = 1 << (c - 1)
    per = sched.bucket_chunks.diff().reshape(sets * W, half)
    mags = torch.arange(1, half + 1, device=per.device)
    top = float(((per > 0) * mags).max(dim=1).values.sum())
    pt = 12 * limbs
    return (pt * C + 4 * (per.numel() + 1) + pt * sets,
            formula_products(limbs, ADD) * (C + top + sets * W)
            + formula_products(limbs, DOUBLE) * sets * c * (W - 1))


PATH_WIDTHS: dict = {}      # path -> {kernel: {width class: launches}}
PATH_LIMBS: dict = {}       # path -> {kernel: {limb count: launches}}
PATH_TRANSFORMS: dict = {}  # path -> {n: staged transforms}
TRANSFORMS: collections.Counter = collections.Counter()


def count_transforms() -> None:
    """Count the staged transforms that ops/ntt.py runs, by n, into
    TRANSFORMS (a wrapper around its staged_transform)."""
    from kzg_snark_tpu_torch.ops import ntt
    inner = ntt.staged_transform

    def counted(fc, x, tw):
        TRANSFORMS[x.shape[1]] += 1
        return inner(fc, x, tw)
    ntt.staged_transform = counted


def run_path(torch, paths, name, fn):
    """Drive one path with the launch counts set to 0 just before it and
    read just after (also by width, into PATH_WIDTHS, by limb count, into
    PATH_LIMBS, and its staged transforms by n, into PATH_TRANSFORMS);
    returns what ``fn`` returns."""
    from kzg_snark_tpu_torch.utils.build import (launch_counts, launch_limbs,
                                                 launch_widths,
                                                 reset_launches)
    torch.cuda.synchronize()
    reset_launches()
    TRANSFORMS.clear()
    out = fn()
    torch.cuda.synchronize()
    paths[name] = launch_counts()
    PATH_WIDTHS[name] = launch_widths()
    PATH_LIMBS[name] = launch_limbs()
    PATH_TRANSFORMS[name] = dict(sorted(TRANSFORMS.items()))
    return out


def check_ntt_passes(name: str, counts: dict) -> None:
    """ntt_pass on the path made ceil(log2 n / t) launches a staged
    transform, and at most 2."""
    from kzg_snark_tpu_torch.ops.ntt_stage import pass_plan, tile_bits
    tf = PATH_TRANSFORMS[name]
    t = tile_bits()
    want = sum(k * len(pass_plan(n, t)) for n, k in tf.items())
    got = counts.get("ntt_pass", 0)
    if not tf or got != want or got > 2 * sum(tf.values()):
        raise AssertionError(f"the {name} path launched ntt_pass {got} "
                             f"times for staged transforms {tf} (expected "
                             f"{want}, at most 2 a transform)")
    log(f"[{name}] staged transforms by n: {json.dumps(tf)}; ntt_pass "
        f"launches {got} (tiles of 2^{t})")


def phase_ntt(torch, dev, paths, rates):
    from kzg_snark_tpu_torch.ops.host.field import scalar_field
    from kzg_snark_tpu_torch.ops.ntt import ntt_context
    from kzg_snark_tpu_torch.ops.ntt_stage import (ntt_pass, ntt_pass_plain,
                                                   pass_plan,
                                                   staged_transform,
                                                   tile_bits)

    T = tile_bits()
    sizes = sorted({2, 1 << T, 2 << T, 1 << 15, 1 << MAIN_LOG_N,
                    1 << (MAIN_LOG_N + 2)})
    for m in sizes:
        cm = ntt_context("bn254", m, dev)
        fr = cm.backend.consts
        xm = random_canonical(torch, m, 40 + m.bit_length(), dev)
        for tw in (cm.tw_fwd, cm.tw_inv):
            y = xm
            for s0, g in pass_plan(m, T):
                got = ntt_pass(fr, y, tw, s0, g, T)
                y = ntt_pass_plain(fr, y, tw, s0, g)
                if not torch.equal(got, y):
                    raise AssertionError(f"ntt_pass differs from plain at "
                                         f"n = {m}, stages {s0}..+{g}")
            if not torch.equal(staged_transform(fr, xm, tw), y):
                raise AssertionError(f"staged transform at n = {m} differs")
    log(f"[ntt] ntt_pass == plain for every pass of the plan (tile 2^{T}) "
        f"at n = {sizes}, forward and inverse tables, and the whole staged "
        f"transform")

    for lg in (15, MAIN_LOG_N, MAIN_LOG_N + 2):
        m = 1 << lg
        cm = ntt_context("bn254", m, dev)
        fr = cm.backend.consts
        xm = random_canonical(torch, m, 50 + lg, dev)
        want = staged_transform(fr, xm, cm.tw_fwd)
        cells = []
        for t in NTT_TILES_TRIED:
            def passes(u, tw, t=t):
                """staged_transform's passes with 2^t-element tiles."""
                y = None
                for s0, g in pass_plan(m, t):
                    y = ntt_pass(fr, u if y is None else y, tw, s0, g, t, y)
                return y
            if not torch.equal(passes(xm, cm.tw_fwd), want):
                raise AssertionError(f"NTT 2^{lg} with 2^{t} tiles differs")
            d, w = timed_ms(torch, rotated(torch, passes, (xm, cm.tw_fwd)),
                            10)
            cells.append(f"t = {t}{'*' if t == T else ''}: {d:.4f} / "
                         f"{w:.4f} ({len(pass_plan(m, t))} launches)")
        b = ntt_bound(rates, m)
        log(f"[ntt] 2^{lg} forward transform, device ms / wall ms by tile "
            f"bits (* = NTT_TILE_BITS): " + "; ".join(cells)
            + f"; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")

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
    y_scan, back_scan = run_path(
        torch, paths, "ntt_scan",
        lambda: (ctx.ntt(x, mode="scan"), ctx.intt(y, mode="scan")))
    if not torch.equal(y_scan, y) or not torch.equal(back_scan, x):
        raise AssertionError("NTT 2^18 scan mode differs from staged")
    sfwd_ms, sfwd_wall = timed_ms(torch, lambda: ctx.ntt(x, mode="scan"), 5)
    sinv_ms, sinv_wall = timed_ms(torch, lambda: ctx.intt(x, mode="scan"),
                                  5)
    Fr = scalar_field("bn254")
    r = Fr.modulus
    coeffs = be.to_ints(x)
    evals = be.to_ints(y)
    for j in (0, 1, 12345 % n, n - 1):
        pt = pow(ctx.root, j, r)
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * pt + c) % r
        if acc != evals[j]:
            raise AssertionError(f"NTT 2^18 output {j} != host Horner")
    log(f"[ntt] n=2^18 round trip exact, 4 outputs == host Horner, scan == "
        f"staged (forward and inverse); device ms: staged ntt "
        f"{fwd_ms:.3f}, intt {inv_ms:.3f}; scan ntt {sfwd_ms:.3f}, intt "
        f"{sinv_ms:.3f}; wall ms: staged ntt {fwd_wall:.3f}, intt "
        f"{inv_wall:.3f}; scan ntt {sfwd_wall:.3f}, intt {sinv_wall:.3f}")
    log(f"[ntt] scan path launches: "
        f"{json.dumps(paths['ntt_scan'], sort_keys=True)}")


def phase_msm(torch, dev, paths, rates):
    """The bucket-route MSM at 2^16 points against the host oracle (random
    scalars with 0, 1, r - 1, r - 2; all equal; one nonzero; k = 9 sets),
    its stages' times, the launches of one MSM, its operation bounds, and
    the table of MSM time by window width c and n (2^11..2^18)."""
    import numpy as np
    from kzg_snark_tpu_torch import constants as C
    from kzg_snark_tpu_torch.ops import msm_kernel as mk
    from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
    from kzg_snark_tpu_torch.ops.host import curve as hc
    from kzg_snark_tpu_torch.ops.host.field import base_field
    from kzg_snark_tpu_torch.ops.limbs import (ints_to_words, to_tensor,
                                               words_to_ints)
    from kzg_snark_tpu_torch.ops.msm import msm_context

    n = 1 << MAIN_LOG_N
    t0 = time.perf_counter()
    big, ks_big = run_path(
        torch, paths, "msm_basis", lambda: random_point_basis(
            "bn254", 1 << MSM_TABLE_LOG_N[-1], seed=20260820, device=dev))
    basis_s = time.perf_counter() - t0
    pts, ks = big[..., :n].contiguous(), ks_big[:n]
    ctx = msm_context("bn254", dev)
    r = C.BN254_R
    Fp = base_field("bn254")

    def oracle(ints):
        total = sum(s * k for s, k in zip(ints, ks)) % r
        exp = hc.normalize(hc.multiply((Fp(1), Fp(2), Fp(1)), total))
        return None if exp is None else (int(exp[0]), int(exp[1]))

    def random_words(seed):
        w = np.random.default_rng(seed).integers(0, 1 << 32, size=(8, n),
                                                 dtype=np.uint64)
        w[7] &= (1 << 29) - 1
        words = w.astype(np.uint32)
        special = [0, 1, r - 1, 2, r - 2]
        words[:, :len(special)] = ints_to_words(special)
        return words

    words = random_words(9000)
    scalars = to_tensor(words, dev)
    ms, wall = timed_ms(torch, lambda: ctx.msm(pts, scalars), 5)
    got = ctx.curve.to_affine_ints(ctx.msm(pts, scalars))[0]
    if got != oracle(words_to_ints(words)):
        raise AssertionError(f"MSM 2^{MAIN_LOG_N} differs from the host "
                             "oracle")
    if paths["msm_basis"].get("g1_add_mixed", 0) == 0:
        raise AssertionError("the basis build did not launch g1_add_mixed")
    third = n // 3
    skewed = {"all-equal": [r - 3] * n,
              "one-nonzero": [0] * third + [r - 1] + [0] * (n - third - 1)}
    for name, ints in skewed.items():
        res = ctx.curve.to_affine_ints(ctx.msm(pts, ctx.scalars_to_limbs(
            ints)))[0]
        if res != oracle(ints):
            raise AssertionError(f"MSM 2^{MAIN_LOG_N} ({name}) differs from "
                                 "the oracle")
    sets9 = [random_words(9100 + j) for j in range(9)]
    res = ctx.curve.to_affine_ints(ctx.msm(pts, to_tensor(np.stack(sets9),
                                                            dev)))
    if res != [oracle(words_to_ints(w)) for w in sets9]:
        raise AssertionError(f"MSM 2^{MAIN_LOG_N} with k = 9 sets differs "
                             "from the oracle")
    log(f"[msm] 2^{MAIN_LOG_N} points == host oracle (random, all-equal, "
        f"one-nonzero, k = 9 sets); device {ms:.3f} ms, wall {wall:.3f} ms "
        f"({n / wall * 1e3:.0f} points/s), basis build of 2^"
        f"{MSM_TABLE_LOG_N[-1]} points {basis_s:.2f} s, its launches "
        f"{json.dumps(paths['msm_basis'], sort_keys=True)}")

    # Stages of one MSM at the main size (random scalars), device and wall ms.
    fm = ctx.fused
    fq = fm.curve.f.consts
    k, c, W, sched = fm.schedule(scalars, n)
    xy = mk.point_table(pts)
    part = mk.msm_accumulate(fq, xy, sched.entries, sched.chunk_off, False)
    wparts = mk.reduce_window_sums(fq, part, sched.bucket_chunks, W, c,
                                   sched.window_threads)
    stages = {
        "digits + sort": lambda: fm.schedule(scalars, n),
        "point table": lambda: mk.point_table(pts),
        "accumulate": lambda: mk.msm_accumulate(
            fq, xy, sched.entries, sched.chunk_off, False),
        "bucket and window sums": lambda: mk.reduce_window_sums(
            fq, part, sched.bucket_chunks, W, c, sched.window_threads),
        "horner": lambda: mk.reduce_horner(fq, wparts, 1, W, c)}
    times = {name: timed_ms(torch, fn, 5) for name, fn in stages.items()}
    log(f"[msm] 2^{MAIN_LOG_N} stages, (device ms, wall ms): "
        + "; ".join(f"{name} ({d:.4f}, {w:.4f})"
                    for name, (d, w) in times.items())
        + f"; c = {c}, W = {W}, T = {mk.CHUNK}, entries "
        f"{sched.entries.numel()}, chunks {sched.chunk_off.numel() - 1}, "
        f"reduce threads a window {sched.window_threads}")
    run_path(torch, paths, "msm_one", lambda: ctx.msm(pts, scalars))
    acts, busy = device_activities(torch, lambda: ctx.msm(pts, scalars))
    log(f"[msm] one 2^{MAIN_LOG_N} MSM: kernel launches "
        f"{json.dumps(paths['msm_one'], sort_keys=True)}; {acts} device "
        f"activities (all kernels and copies, torch.profiler), device busy "
        f"{busy:.3f} ms")
    nbytes_a, prod_a = accumulate_work(n, sched)
    nbytes_r, prod_r = reduce_work(sched, 1, W, c)
    d7 = mk.signed_digits(scalars, 254, 7)
    prod7 = float(((d7 & mk.MAG_MASK) != 0).sum()) * 11 * MONT_PRODUCTS
    log(f"[msm] operations bound at 2^{MAIN_LOG_N}: this design (c = {c}) "
        f"{(prod_a + prod_r) / rates['products'] * 1e3:.4f} ms (accumulate "
        f"{prod_a:.4g} + reduce {prod_r:.4g} 32-bit products); the c = 7 "
        f"pass of the table design {prod7 / rates['products'] * 1e3:.4f} ms "
        f"({prod7:.4g} products, its reduction not counted)")

    # MSM time by c and n: the kernels alone (accumulate and reduce on a
    # ready schedule, device ms) and the whole route (wall ms); the
    # schedule's time and memory at 2^18 points (Marlin's largest commit
    # slice).
    for lg in MSM_TABLE_LOG_N:
        m = 1 << lg
        xy_m = mk.point_table(big[..., :m])
        sets = to_tensor(random_words(9200 + lg)[:, :m].copy()
                         if m <= n else np.concatenate(
                             [random_words(9200 + lg + j)
                              for j in range(m // n)], axis=1), dev)[None]
        c0 = mk.window_bits(m)
        row, want = [], None
        for cc in range(max(c0 - 3, 8), min(c0 + 2, 16) + 1):
            s_, W_, _ = bucket_schedule(torch, sets, cc)

            def kernels(s_=s_, W_=W_, cc=cc):
                p_ = mk.msm_accumulate(fq, xy_m, s_.entries, s_.chunk_off,
                                       False)
                return mk.msm_reduce(fq, p_, s_.bucket_chunks, 1, W_, cc,
                                     s_.window_threads)

            def route(cc=cc):
                s2, W2, _ = bucket_schedule(torch, sets, cc)
                p_ = mk.msm_accumulate(fq, xy_m, s2.entries, s2.chunk_off,
                                       False)
                return mk.msm_reduce(fq, p_, s2.bucket_chunks, 1, W2, cc,
                                     s2.window_threads)
            aff = ctx.curve.to_affine_ints(kernels())
            if want is not None and aff != want:
                raise AssertionError(f"MSM 2^{lg}: c = {cc} differs")
            want = aff
            dk, _ = timed_ms(torch, kernels, 5)
            _, w = timed_ms(torch, route, 3)
            row.append(f"c={cc}{'*' if cc == c0 else ''} {dk:.3f}/{w:.3f}")
        log(f"[msm] table 2^{lg} (kernels device ms / whole route wall ms, "
            f"* = chosen): " + ", ".join(row))
        if lg == MSM_TABLE_LOG_N[-1]:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            s_, _, _ = bucket_schedule(torch, sets)
            peak = torch.cuda.max_memory_allocated() - base
            d, w = timed_ms(torch, lambda: bucket_schedule(torch, sets), 3)
            log(f"[msm] 2^{lg} schedule (digits, sort of "
                f"{s_.entries.numel()} keys, chunks): device {d:.3f} ms, "
                f"wall {w:.3f} ms, peak memory above the inputs {peak} "
                f"bytes")
    for T in (8, 16, 32):
        row = []
        for ev in (4, 8, 16):
            s_, W_, c_ = bucket_schedule(torch, scalars[None], None, T, ev)

            def kernels(s_=s_, W_=W_, c_=c_):
                p_ = mk.msm_accumulate(fq, xy, s_.entries, s_.chunk_off,
                                       False)
                return mk.msm_reduce(fq, p_, s_.bucket_chunks, 1, W_, c_,
                                     s_.window_threads)
            d, _ = timed_ms(torch, kernels, 5)
            row.append(f"events {ev}: {d:.3f}")
        log(f"[msm] 2^{MAIN_LOG_N}, T = {T} (kernels device ms): "
            + ", ".join(row))


PREPARED_LOG_N = (16, 20)       # BN254 sizes of the prepared MSM checks
PREPARED_SETS = (1, 8)
PREPARED_RANGES = 6             # ranges of the forced split at 2^20
MEMORY_LOG_N = (20, 22)         # sizes of the peak-memory measurements
PREPARED_BASIS_LOG_N = 18       # BN254 basis; tiled above it (complete adds)


def random_sets(k: int, n: int, seed: int, top_bits: int = 29):
    """(k, 8, n) uint32 scalar words, uniform below 2^(224 + top_bits)
    (at 29 below both curves' r)."""
    import numpy as np
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(k, 8, n),
                                             dtype=np.uint64)
    w[:, 7] &= (1 << top_bits) - 1
    return w.astype(np.uint32)


def digit_sums(words, ks):
    """sum_i s_i k_i for each set, exact, on the host: words (k, 8, n)
    uint32 and 128-bit multipliers k_i, as 16-bit digits, one float64
    product of (16, n) by (n, 8) a set (each digit sum is below n 2^32 <=
    2^52 for n <= 2^20, so every partial sum is an exact integer)."""
    import numpy as np
    from kzg_snark_tpu_torch.ops.limbs import ints_to_words
    n = words.shape[-1]
    if n > 1 << 20:
        raise ValueError("digit_sums: at most 2^20 points")
    kw = ints_to_words(ks)[:4]
    kd = np.empty((len(ks), 8), dtype=np.float64)
    kd[:, 0::2] = (kw & 0xFFFF).T
    kd[:, 1::2] = (kw >> 16).T
    kd = np.tile(kd, (n // len(ks), 1))
    out = []
    for wj in words:
        sd = np.empty((16, n), dtype=np.float64)
        sd[0::2] = wj & 0xFFFF
        sd[1::2] = wj >> 16
        m = sd @ kd
        out.append(sum(int(m[a, b]) << (16 * (a + b))
                       for a in range(16) for b in range(8)))
    return out


def phase_msm_prepared(torch, dev, paths):
    """The bucket-route MSM through ``FusedMsm.prepare_points`` and
    ``msm_prepared``: BN254 at 2^16 (the basis's first points) and 2^20
    (the 2^18 basis tiled, complete adds), BLS12-381 at 2^16, k = 1 and 8
    sets, each equal to ``MsmContext.msm`` (Jacobian words) and to the host
    oracle; at 2^20 the same MSMs forced into ranges by a lowered
    MAX_SCHEDULE_ENTRIES (equal affine points, K6 adds the ranges), device
    ms split against unsplit; the peak device memory of one MSM at 2^20
    and 2^22 points, k = 1 and 8, both curves.  Paths: msm_prepared (the
    unsplit runs) and msm_prepared_split."""
    from kzg_snark_tpu_torch import constants as C
    from kzg_snark_tpu_torch.ops import msm_kernel as mk
    from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
    from kzg_snark_tpu_torch.ops.g1 import generator
    from kzg_snark_tpu_torch.ops.host import curve as hc
    from kzg_snark_tpu_torch.ops.host.field import base_field
    from kzg_snark_tpu_torch.ops.limbs import to_tensor
    from kzg_snark_tpu_torch.ops.msm import msm_context

    t_phase = time.perf_counter()
    bases = {"bn254": random_point_basis("bn254", 1 << PREPARED_BASIS_LOG_N,
                                         seed=20261017, device=dev),
             "bls12_381": random_point_basis("bls12_381", 1 << BLS_MSM_LOG_N,
                                             seed=20261018, device=dev)}

    def points(curve, n):
        pts, ks = bases[curve]
        reps = max(1, n // pts.shape[-1])
        return pts.repeat(1, 1, reps)[..., :n].contiguous(), ks[:n], reps > 1

    def oracle(curve, words, ks):
        r = C.BN254_R if curve == "bn254" else C.BLS12_381_R
        Fp = base_field(curve)
        gx, gy = generator(curve)
        out = []
        for total in digit_sums(words, ks):
            a = hc.normalize(hc.multiply((Fp(gx), Fp(gy), Fp(1)), total % r))
            out.append(None if a is None else (int(a[0]), int(a[1])))
        return out

    cases = [("bn254", lg, k) for lg in PREPARED_LOG_N for k in PREPARED_SETS]
    cases += [("bls12_381", BLS_MSM_LOG_N, k) for k in PREPARED_SETS]
    inputs = {}
    for curve, lg, k in cases:
        n = 1 << lg
        pts, ks, tiled = points(curve, n)
        words = random_sets(k, n, 9400 + lg + k)
        sc = to_tensor(words, dev)
        inputs[curve, lg, k] = (pts, ks, tiled, words,
                                sc if k > 1 else sc[0])
    results = {}
    fused = {curve: msm_context(curve, dev).fused for curve in bases}

    def unsplit():
        for key, (pts, _, tiled, _, sc) in inputs.items():
            fm = fused[key[0]]
            results[key] = fm.msm_prepared(fm.prepare_points(pts), sc,
                                           complete=tiled)
    run_path(torch, paths, "msm_prepared", unsplit)
    for key, (pts, ks, tiled, words, sc) in inputs.items():
        curve, lg, k = key
        ctx = msm_context(curve, dev)
        if not torch.equal(results[key], ctx.msm(pts, sc, complete=tiled)):
            raise AssertionError(f"msm_prepared {curve} 2^{lg} k = {k} "
                                 f"differs from msm")
        if ctx.curve.to_affine_ints(results[key]) != oracle(curve, words,
                                                             ks):
            raise AssertionError(f"msm_prepared {curve} 2^{lg} k = {k} "
                                 f"differs from the host oracle")
    want = {"msm_accumulate": len(inputs), "msm_reduce": 2 * len(inputs)}
    if paths["msm_prepared"] != want:
        raise AssertionError(f"the msm_prepared path launched "
                             f"{paths['msm_prepared']}, expected {want}")
    log(f"[msm_prepared] prepare_points + msm_prepared == msm (Jacobian "
        f"words) == host oracle: " + ", ".join(
            f"{c_} 2^{lg_} k = {k_}"
            + (" (tiled, complete)" if inputs[c_, lg_, k_][2] else "")
            for c_, lg_, k_ in inputs) + f"; launches "
        f"{json.dumps(paths['msm_prepared'], sort_keys=True)}")

    # The forced split at 2^20, k = 1 and 8.
    lg = PREPARED_LOG_N[-1]
    n = 1 << lg
    fm = fused["bn254"]
    rows, split_out = [], {}
    limit0 = mk.MAX_SCHEDULE_ENTRIES
    for k in PREPARED_SETS:
        pts, ks, tiled, words, sc = inputs["bn254", lg, k]
        table = fm.prepare_points(pts)
        size = -(-n // PREPARED_RANGES)
        c = mk.window_bits(size)
        whole_ms, whole_wall = timed_ms(
            torch, lambda: fm.msm_prepared(table, sc, complete=True), 3)
        limit = k * mk.num_windows(fm.total_bits, c) * size
        try:
            mk.MAX_SCHEDULE_ENTRIES = limit
            ranges = mk.point_ranges(n, k, fm.total_bits)
            if not 4 <= len(ranges) <= 8:
                raise AssertionError(f"the forced split gave {len(ranges)} "
                                     f"ranges")
            split_out[k] = run_path(
                torch, paths, f"msm_prepared_split_k{k}",
                lambda: fm.msm_prepared(table, sc, complete=True))
            split_ms, split_wall = timed_ms(
                torch, lambda: fm.msm_prepared(table, sc, complete=True), 3)
        finally:
            mk.MAX_SCHEDULE_ENTRIES = limit0
        aff = fm.curve.to_affine_ints(split_out[k])
        if aff != fm.curve.to_affine_ints(results["bn254", lg, k]) \
                or aff != oracle("bn254", words, ks):
            raise AssertionError(f"the split MSM 2^{lg} k = {k} differs from "
                                 f"the unsplit one or the oracle")
        launches = paths[f"msm_prepared_split_k{k}"]
        want = {"msm_accumulate": len(ranges),
                "msm_reduce": 2 * len(ranges), "g1_add": len(ranges) - 1}
        if launches != want:
            raise AssertionError(f"the split MSM k = {k} launched "
                                 f"{launches}, expected {want}")
        rows.append(f"k = {k}: {len(ranges)} ranges of "
                    f"{sorted({b - a for a, b in ranges}, reverse=True)} "
                    f"points (limit {limit}), "
                    f"device ms split {split_ms:.3f} / unsplit "
                    f"{whole_ms:.3f}, wall {split_wall:.3f} / "
                    f"{whole_wall:.3f}; launches "
                    f"{json.dumps(launches, sort_keys=True)}")
    paths["msm_prepared_split"] = {
        name: sum(paths[f"msm_prepared_split_k{k}"].get(name, 0)
                  for k in PREPARED_SETS) for name in KERNELS}
    log(f"[msm_prepared] 2^{lg} forced split (K6 adds the ranges) == "
        f"unsplit == host oracle: " + "; ".join(rows))
    del inputs, results, split_out

    # Peak device memory of one MSM (the table and scalars already made).
    for curve, fm in fused.items():
        for lg_m in MEMORY_LOG_N:
            n = 1 << lg_m
            pts, _, tiled = points(curve, n)
            table = fm.prepare_points(pts)
            for k in PREPARED_SETS:
                sc = to_tensor(random_sets(k, n, 9500 + lg_m + k), dev)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fm.msm_prepared(table, sc if k > 1 else sc[0],
                                complete=tiled)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                held = pts.numel() * 4 + table.numel() * 4 + sc.numel() * 4
                c = mk.window_bits(n)
                log(f"[msm_prepared] peak memory {curve} 2^{lg_m} points, "
                    f"k = {k} (c = {c}, W = "
                    f"{mk.num_windows(fm.total_bits, c)}): "
                    f"{peak} bytes above the inputs, {peak / n:.1f} bytes "
                    f"a point, {peak / (n * k):.1f} a point a set; inputs "
                    f"(points, table, scalars) {held} bytes, "
                    f"{held / n:.1f} a point")
                del sc
            del pts, table
    log(f"[msm_prepared] phase in {time.perf_counter() - t_phase:.1f} s")


# The BLS12-381 path where each kernel's BLS launches count.
BLS_PATHS = {name: "bls_main" for name in KERNELS}
BLS_PATHS.update(g1_double="bls_parity", g1_ladder="bls_parity",
                 g1_add_mixed="bls_msm_basis", fr_butterfly="bls_ntt_scan")
BLS_MSM_LOG_N = 16
BLS_POW_LOG_N = 16          # fr_pow's width: its plain version at 2^18
                            # takes about 6 s at 8 words


def phase_bls_kernels(torch, dev, rows, rates, basis, ks):
    """Every kernel at BLS12-381 against its plain version, exactly:
    K1 and the chains at Fr (8 words) and Fq (12 words), the NTT pass and
    K10 at Fr, the curve kernels, the SRS table and the bucket kernels at
    Fq; the main paths' shapes but fr_pow (2^16 at Fr, 2^14 at Fq, where
    the plain version takes seconds).  ``rows[name]`` gets one row a
    field."""
    from kzg_snark_tpu_torch import constants as C
    from kzg_snark_tpu_torch.ops import cuda_fr, scan
    from kzg_snark_tpu_torch.ops import msm_kernel as mk
    from kzg_snark_tpu_torch.ops.fr import fq_backend, fr_backend
    from kzg_snark_tpu_torch.ops.ntt import ntt_context
    from kzg_snark_tpu_torch.ops.ntt_stage import (butterfly_plain,
                                                   fr_butterfly,
                                                   ntt_pass_plain,
                                                   staged_transform)
    from kzg_snark_tpu_torch.ops.srs import (fixed_base_table_plain,
                                             g1_fixed_base_table)

    def row(name, field, shape, *args, **kw):
        got = {}
        compare(torch, f"bls {name} {field}", got, *args, **kw)
        rows.setdefault(name, []).append(
            {"curve": "bls12_381", "field": field, "shape": shape,
             **got[f"bls {name} {field}"]})

    fr_be, fq_be = fr_backend("bls12_381", dev), fq_backend("bls12_381", dev)
    n_field = 1 << (MAIN_LOG_N + 2)
    n = 1 << MAIN_LOG_N
    for field, be in (("Fr", fr_be), ("Fq", fq_be)):
        fc, L = be.consts, be.num_limbs
        a = random_canonical(torch, n_field, 61, dev, L)
        b = random_canonical(torch, n_field, 62, dev, L)
        elem = 4 * L * n_field
        for name, k, p, prods in [
                ("fr_mul", cuda_fr.fr_mul, cuda_fr.mul_plain,
                 mont_products(L)),
                ("fr_add", cuda_fr.fr_add, cuda_fr.add_plain, 0),
                ("fr_sub", cuda_fr.fr_sub, cuda_fr.sub_plain, 0)]:
            row(name, field, f"({L}, 2^18)",
                lambda x, y, k=k, fc=fc: k(fc, x, y),
                lambda x, y, p=p, fc=fc: p(fc, x, y), (a, b),
                bound(rates, 3 * elem, prods * n_field))
        xs = a[:, :n].clone()
        xs[:, xs.eq(0).all(dim=0)] = be.one_mont  # products: no zero
        cat = lambda pair: torch.cat(pair, dim=1)                # noqa
        row("fr_scan", field, f"({L}, 2^16) product scan and total",
            lambda u, fc=fc: cat(scan.fr_scan(fc, u, scan.MUL)),
            lambda u, fc=fc: cat(scan.fr_scan_plain(fc, u, scan.MUL)),
            (xs,), bound(rates, 8 * L * n + 4 * L,
                         mont_products(L) * (n - 1)))
        e = be.modulus - 2
        steps = e.bit_length() - 1 + bin(e).count("1")
        w = 1 << (BLS_POW_LOG_N if field == "Fr" else BLS_POW_LOG_N - 2)
        xp = a[:, :w].contiguous()
        row("fr_pow", field, f"({L}, 2^{w.bit_length() - 1}), e = p - 2",
            lambda u, fc=fc, e=e: scan.fr_pow(fc, u, e),
            lambda u, fc=fc, e=e: scan.fr_pow_plain(fc, u, e), (xp,),
            bound(rates, 8 * L * w, mont_products(L) * steps * w), reps=5,
            plain_reps=1)

    fr = fr_be.consts
    a = random_canonical(torch, n_field, 63, dev)
    ctx = ntt_context("bls12_381", n_field, dev)
    log_n = n_field.bit_length() - 1
    row("ntt_pass", "Fr", "a 2^18 transform",
        lambda u, tw: staged_transform(fr, u, tw),
        lambda u, tw: ntt_pass_plain(fr, u, tw, 0, log_n),
        (a, ctx.tw_fwd), ntt_bound(rates, n_field), reps=10, plain_reps=1)
    import numpy as np
    mask = torch.from_numpy(np.random.default_rng(64).integers(
        0, 2, n_field).astype(np.int32)).to(dev)
    b, tw = (random_canonical(torch, n_field, s_, dev) for s_ in (65, 66))
    row("fr_butterfly", "Fr", "(8, 2^18)",
        lambda u, v, t, m: fr_butterfly(fr, u, v, t, m),
        lambda u, v, t, m: butterfly_plain(fr, u, v, t, m),
        (a, b, tw, mask),
        bound(rates, 4 * 32 * n_field + 4 * n_field,
              MONT_PRODUCTS * n_field))

    fq = fq_be.consts
    L = fq.num_limbs
    pts = basis[..., :n].contiguous()
    shapes = {"g1_add_mixed": "2^16 points, one q"}
    curve_rows(torch, rates, fq_be, pts,
               lambda name, *a: row(name, "Fq",
                                    shapes.get(name, "2^16 points"), *a,
                                    plain_reps=1))
    check_edge_batches(torch, fq, "bls12_381", pts)
    got: dict = {}
    check_ladder(torch, fq, "bls12_381", pts, ks, rates, got,
                 "bls g1_ladder Fq")
    rows.setdefault("g1_ladder", []).append(
        {"curve": "bls12_381", "field": "Fq",
         "shape": "one small MSM, n = 256, k = 1", **got["bls g1_ladder Fq"]})
    base = curve_base(torch, dev, "bls12_381")
    windows = -(-C.BLS12_381_R.bit_length() // SRS_WINDOW_BITS)
    row("g1_fixed_base_table", "Fq", f"c = 8, W = {windows}",
        lambda u: g1_fixed_base_table(fq, u, SRS_WINDOW_BITS, windows),
        lambda u: fixed_base_table_plain(fq, u, SRS_WINDOW_BITS, windows),
        (base,), table_bound(rates, SRS_WINDOW_BITS, windows, L), reps=5,
        plain_reps=1)

    xy = mk.point_table(pts)
    bits = C.BLS12_381_R.bit_length()
    sched, W, c = bucket_schedule(
        torch, random_canonical(torch, n, 67, dev)[None], bits=bits)
    row("msm_accumulate", "Fq", f"2^16 points, c = {c}",
        lambda u, e_, o: mk.msm_accumulate(fq, u, e_, o, False),
        lambda u, e_, o: mk.msm_accumulate_plain(fq, u, e_, o, False),
        (xy, sched.entries, sched.chunk_off),
        bound(rates, *accumulate_work(n, sched, L)), reps=10, plain_reps=1)
    part = mk.msm_accumulate(fq, xy, sched.entries, sched.chunk_off, False)
    row("msm_reduce", "Fq", f"2^16 points, {W} windows",
        lambda u, bc: mk.msm_reduce(fq, u, bc, 1, W, c,
                                    sched.window_threads),
        lambda u, bc: mk.msm_reduce_plain(fq, u, bc, 1, W, c,
                                          sched.window_threads),
        (part, sched.bucket_chunks),
        bound(rates, *reduce_work(sched, 1, W, c, L)), reps=10,
        plain_reps=1)


def phase_bls(torch, dev, paths, rates, rows):
    """The BLS12-381 phases: the random-multiplier basis (K9 at 12 words,
    the bls_msm_basis path), every kernel against its plain version
    (``phase_bls_kernels``), the bucket-route MSM at 2^16 points against
    the host oracle, the scan-mode NTT (K10, the bls_ntt_scan path), PLONK
    at n = 2^6 against the host prover (bls_parity) and PLONK at n = 2^16
    (bls_main, with the main path's guards)."""
    import numpy as np
    from kzg_snark_tpu_torch import constants as C
    from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
    from kzg_snark_tpu_torch.ops.host import curve as hc
    from kzg_snark_tpu_torch.ops.host.field import base_field
    from kzg_snark_tpu_torch.ops.limbs import to_tensor, words_to_ints
    from kzg_snark_tpu_torch.ops.msm import msm_context
    from kzg_snark_tpu_torch.ops.ntt import ntt_context

    t_bls = time.perf_counter()
    n = 1 << BLS_MSM_LOG_N
    t0 = time.perf_counter()
    pts, ks = run_path(
        torch, paths, "bls_msm_basis", lambda: random_point_basis(
            "bls12_381", n, seed=20261017, device=dev))
    log(f"[bls] random-multiplier basis of 2^{BLS_MSM_LOG_N} points (3, "
        f"{pts.shape[1]}, n) in {time.perf_counter() - t0:.2f} s, launches "
        f"{json.dumps(paths['bls_msm_basis'], sort_keys=True)}")
    phase_bls_kernels(torch, dev, rows, rates, pts, ks)

    r = C.BLS12_381_R
    Fp = base_field("bls12_381")
    G = (Fp(C.BLS12_381_G1[0]), Fp(C.BLS12_381_G1[1]), Fp(1))
    w = np.random.default_rng(9300).integers(0, 1 << 32, size=(8, n),
                                             dtype=np.uint64)
    w[7] &= (1 << 30) - 1                   # below 2^254 < r
    words = w.astype(np.uint32)
    words[:, :4] = np.stack([np.array([(v >> (32 * i)) & 0xFFFFFFFF
                                       for i in range(8)], dtype=np.uint32)
                             for v in (0, 1, r - 1, r - 2)], axis=1)
    ctx = msm_context("bls12_381", dev)
    scalars = to_tensor(words, dev)
    ms, wall = timed_ms(torch, lambda: ctx.msm(pts, scalars), 5)
    got = ctx.curve.to_affine_ints(ctx.msm(pts, scalars))[0]
    total = sum(s_ * k_ for s_, k_ in zip(words_to_ints(words), ks)) % r
    want = hc.normalize(hc.multiply(G, total))
    if want is None or got != (int(want[0]), int(want[1])):
        raise AssertionError(f"BLS12-381 MSM 2^{BLS_MSM_LOG_N} differs from "
                             "the host oracle")
    k_, c, W, _ = ctx.fused.schedule(scalars, n)
    log(f"[bls] MSM 2^{BLS_MSM_LOG_N} points (bucket route, c = {c}, W = "
        f"{W}) == host oracle; device {ms:.3f} ms, wall {wall:.3f} ms")

    nn = 1 << MAIN_LOG_N
    nctx = ntt_context("bls12_381", nn, dev)
    x = nctx.backend.to_mont(random_canonical(torch, nn, 68, dev))
    y = nctx.ntt(x)
    y_scan, back = run_path(torch, paths, "bls_ntt_scan", lambda: (
        nctx.ntt(x, mode="scan"), nctx.intt(y, mode="scan")))
    if not torch.equal(y_scan, y) or not torch.equal(back, x):
        raise AssertionError("BLS12-381 scan-mode NTT differs from staged")
    log(f"[bls] NTT 2^{MAIN_LOG_N} scan mode (K10) == staged, forward and "
        f"inverse; launches {json.dumps(paths['bls_ntt_scan'])}")

    phase_parity(dev, "bls12_381", "bls_parity",
                 lambda fn: run_path(torch, paths, "bls_parity", fn))
    log(f"[bls_parity] launches "
        f"{json.dumps(paths['bls_parity'], sort_keys=True)}")
    check_ladder_path("bls_parity", paths["bls_parity"])
    phase_main(torch, dev, paths, "bls12_381", "bls_main")
    log(f"[bls] BLS12-381 phases in {time.perf_counter() - t_bls:.1f} s")



def device_activities(torch, fn):
    """(number of device activities, device busy ms) of one call of ``fn``
    under torch.profiler."""
    _, spans, _ = trace(torch, fn)
    return len(spans), busy_ms(spans)


def trace(torch, fn):
    """One call of ``fn`` under torch.profiler -> (wall ms, sorted device
    activity spans in us, the profile)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    return wall_ms, spans, prof


def busy_ms(spans) -> float:
    """The union of the device activity intervals, in ms."""
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _circuit(Fr, n):
    one, zero = Fr(1), Fr(0)
    a = [Fr(i + 2) for i in range(n)]
    b = [Fr(i + 3) for i in range(n)]
    c = [x * y for x, y in zip(a, b)]
    return ([one] * n, [zero] * n, [-one] * n, list(range(3 * n)),
            a + b + c)


def plonk_parity_device(dev, curve):
    """The device part of the PLONK parity run at n = 2^6: (index keys,
    proof)."""
    from kzg_snark_tpu_torch.models.plonk.device import DeviceProver
    from kzg_snark_tpu_torch.ops.host.field import scalar_field
    from kzg_snark_tpu_torch.rng import Rng

    n = 1 << PARITY_LOG_N
    qM, qZ, qO, perm, w = _circuit(scalar_field(curve), n)
    keys = DeviceProver(curve, rng=Rng(600), device=dev).preprocess(
        qM, qZ, qZ, qO, qZ, perm, max_degree=n + 5, tau=TAU)
    return keys, DeviceProver(curve, rng=Rng(601), device=dev).prove(
        keys[0], [], w)


def phase_parity(dev, curve="bn254", tag="parity", run=None):
    """PLONK at n = 2^6 on ``curve``: the device index and proof against
    the port's host prover; ``run(fn)`` drives the device part (a
    run_path)."""
    from kzg_snark_tpu_torch.models.plonk.indexer import Indexer
    from kzg_snark_tpu_torch.models.plonk.prover import Prover
    from kzg_snark_tpu_torch.ops.host.field import scalar_field
    from kzg_snark_tpu_torch.rng import Rng

    n = 1 << PARITY_LOG_N
    qM, qZ, qO, perm, w = _circuit(scalar_field(curve), n)
    args = (qM, qZ, qZ, qO, qZ, perm)

    def device():
        return plonk_parity_device(dev, curve)
    (ipk_d, ivk_d), proof_d = run(device) if run else device()
    t0 = time.perf_counter()
    idx = Indexer(curve, backend="host", rng=Rng(600))
    idx.kzg.normalize_commitments = True
    ipk_h, ivk_h = idx.preprocess(*args, max_degree=n + 5, tau=TAU)
    prover = Prover(curve, backend="host", rng=Rng(601))
    prover.kzg.normalize_commitments = True
    proof_h = prover.prove(ipk_h, [], w)
    host_s = time.perf_counter() - t0
    if ivk_d["commitments"] != ivk_h["commitments"]:
        raise AssertionError(f"{curve} n=2^6 index commitments differ from "
                             "host")
    for part in ("commitments", "evaluations", "kzg_proofs"):
        if proof_d[part] != proof_h[part]:
            raise AssertionError(f"{curve} n=2^6 proof {part} differ from "
                                 "host")
    log(f"[{tag}] PLONK {curve} n=2^6 index and proof byte-identical to the "
        f"host prover (host side {host_s:.1f} s)")


def phase_main(torch, dev, paths, curve="bn254", name="main"):
    """PLONK on ``curve`` at n = 2^16 as the path ``name``: index, two
    proves, host verification and tamper rejection, and the launch
    guards.  Returns the keys, both proofs and their seconds."""
    from kzg_snark_tpu_torch.models.plonk.device import DeviceProver
    from kzg_snark_tpu_torch.models.plonk.verifier import Verifier
    from kzg_snark_tpu_torch.ops.host.field import scalar_field
    from kzg_snark_tpu_torch.rng import Rng

    n = 1 << MAIN_LOG_N
    qM, qZ, qO, perm, w = _circuit(scalar_field(curve), n)
    prover = DeviceProver(curve, rng=Rng(77), collect_timings=True,
                          device=dev)
    torch.cuda.reset_peak_memory_stats()
    times = {}

    def run():
        t0 = time.perf_counter()
        keys = prover.preprocess(qM, qZ, qZ, qO, qZ, perm,
                                 max_degree=n + 5, tau=TAU)
        torch.cuda.synchronize()
        times["index"] = time.perf_counter() - t0
        times["prove"], times["proofs"] = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            proof = prover.prove(keys[0], [], w)
            torch.cuda.synchronize()
            times["prove"].append(time.perf_counter() - t0)
            times["proofs"].append(proof)
        return keys, proof

    (ipk, ivk), proof = run_path(torch, paths, name, run)
    counts = paths[name]
    peak = torch.cuda.max_memory_allocated()
    phases = {k: round(v * 1e3, 3) for k, v in prover.timings.items()}

    t0 = time.perf_counter()
    ok = Verifier(curve, rng=Rng(78)).verify(ivk, [], proof)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError(f"host Verifier rejected the {curve} n=2^16 "
                             "proof")
    tampered = {**proof, "evaluations": {
        **proof["evaluations"], "a": proof["evaluations"]["a"] + 1}}
    if Verifier(curve, rng=Rng(79)).verify(ivk, [], tampered):
        raise AssertionError("host Verifier accepted a tampered proof")
    log(f"[{name}] PLONK {curve} n=2^16: index {times['index']:.3f} s, "
        f"prove {times['prove'][0]:.3f} s then {times['prove'][1]:.3f} s, "
        f"host verify {verify_s:.3f} s: accepted, tampered rejected")
    log(f"[{name}] phases of the second prove (ms): {json.dumps(phases)}; "
        f"sum {sum(phases.values()):.3f} ms")
    log(f"[{name}] peak device memory {peak} bytes "
        f"({peak / 2 ** 30:.3f} GiB)")
    log(f"[{name}] launches: {json.dumps(counts, sort_keys=True)}")
    log(f"[{name}] launches by width (elements or points): "
        f"{json.dumps(PATH_WIDTHS[name], sort_keys=True)}")
    log(f"[{name}] launches by limb count: "
        f"{json.dumps(PATH_LIMBS[name], sort_keys=True)}")
    if counts.get("g1_double", 0) > 0 or counts.get("g1_ladder", 0) > 0 \
            or counts.get("g1_add", 0) > 32 \
            or counts.get("g1_fixed_base_table", 0) != 1 \
            or counts.get("msm_reduce", 0) > 2 * counts.get("msm_accumulate",
                                                            0):
        raise AssertionError(f"the {curve} PLONK path launched g1_double "
                             "or g1_ladder (none allowed), more g1_add (32) "
                             "or msm_reduce (2 an MSM) than the bucket "
                             "route allows, or other than one "
                             "g1_fixed_base_table")
    check_ntt_passes(name, counts)
    chains = counts.get("fr_scan", 0) + counts.get("fr_pow", 0)
    if counts.get("fr_mul", 0) > 2000 or chains > 600:
        raise AssertionError(f"the {curve} PLONK path launched fr_mul "
                             f"{counts.get('fr_mul', 0)} times (limit 2000) "
                             f"and fr_scan + fr_pow {chains} (limit 600)")
    return {"keys": (ipk, ivk), "proofs": times["proofs"],
            "index_s": times["index"], "prove_s": times["prove"],
            "circuit": (qM, qZ, qO, perm, w)}


def check_ladder_path(name: str, counts: dict) -> None:
    """The small MSMs of a parity path ran the ladder (g1_ladder at least
    once) and K7 alone no time."""
    if counts.get("g1_double", 0) != 0 or counts.get("g1_ladder", 0) < 1:
        raise AssertionError(f"the {name} path launched g1_double "
                             f"{counts.get('g1_double', 0)} times (none "
                             f"allowed) and g1_ladder "
                             f"{counts.get('g1_ladder', 0)} (at least 1)")


def marlin_parity_device(dev, curve="bn254"):
    """The device part of the Marlin parity run at |H| = 2^6 on ``curve``:
    (index keys, proof)."""
    from kzg_snark_tpu_torch.models.marlin.device import DeviceProver
    from kzg_snark_tpu_torch.rng import Rng
    from kzg_snark_tpu_torch.utils.fixtures import synthetic_r1cs

    n = 1 << MARLIN_PARITY_LOG_H
    A, B, C, z = synthetic_r1cs(n, curve_type=curve)
    keys = DeviceProver(curve, rng=Rng(900), device=dev).preprocess(
        A, B, C, 6 * 2 * n, tau=MARLIN_TAU)
    return keys, DeviceProver(curve, rng=Rng(901), device=dev).prove(
        keys[0], z[:MARLIN_PUBLIC], z[MARLIN_PUBLIC:])


def marlin_parity_host(curve: str) -> dict:
    """The host side of the Marlin parity run at |H| = 2^6 on ``curve``:
    the port's host Marlin indexer and prover with normalized commitments,
    their index commitments and proof as ints (``to_plain``), and its
    seconds."""
    from kzg_snark_tpu_torch.models.marlin.indexer import Indexer
    from kzg_snark_tpu_torch.models.marlin.prover import Prover
    from kzg_snark_tpu_torch.rng import Rng
    from kzg_snark_tpu_torch.utils.convert import to_plain
    from kzg_snark_tpu_torch.utils.fixtures import synthetic_r1cs

    t0 = time.perf_counter()
    n = 1 << MARLIN_PARITY_LOG_H
    A, B, C, z = synthetic_r1cs(n, curve_type=curve)
    idx = Indexer(curve, backend="host", rng=Rng(900))
    idx.kzg.normalize_commitments = True
    ipk, ivk = idx.preprocess(A, B, C, 6 * 2 * n, tau=MARLIN_TAU)
    prover = Prover(curve, backend="host", rng=Rng(901))
    prover.kzg.normalize_commitments = True
    proof = prover.prove(ipk, z[:MARLIN_PUBLIC], z[MARLIN_PUBLIC:])
    return {"commitments": to_plain(ivk["commitments"]),
            "proof": to_plain(proof), "seconds": time.perf_counter() - t0}


def phase_marlin_parity(torch, dev, paths, curve="bn254",
                        name="marlin_parity"):
    """Marlin at |H| = 2^6 on ``curve`` as the path ``name``: the device
    index and proof byte-identical to the port's host Marlin prover's
    (``marlin_parity_host``); the scan MSM (K9) and the ladder ran, K7
    alone did not."""
    from kzg_snark_tpu_torch.utils.convert import to_plain

    (_, ivk_d), proof_d = run_path(torch, paths, name,
                                   lambda: marlin_parity_device(dev, curve))
    ref = marlin_parity_host(curve)
    if to_plain(ivk_d["commitments"]) != ref["commitments"]:
        raise AssertionError(f"Marlin {curve} |H|=2^6 index commitments "
                             "differ")
    for part in ("commitments", "evaluations", "kzg_proofs"):
        if to_plain(proof_d[part]) != ref["proof"][part]:
            raise AssertionError(f"Marlin {curve} |H|=2^6 proof {part} "
                                 "differ")
    counts = paths[name]
    if counts.get("g1_add_mixed", 0) == 0:
        raise AssertionError(f"the {name} run took no scan MSM (K9)")
    check_ladder_path(name, counts)
    log(f"[{name}] {curve} |H|=2^{MARLIN_PARITY_LOG_H}: index and proof "
        f"byte-identical to the host Marlin prover (host side "
        f"{ref['seconds']:.1f} s); "
        f"launches {json.dumps(counts, sort_keys=True)}")


def phase_marlin(torch, dev, paths, curve="bn254", name="marlin"):
    """Marlin on ``curve`` at |H| = 2^14 as the path ``name``: index, two
    proves, host verification and tamper rejection; returns a steady
    prove for the profile."""
    from kzg_snark_tpu_torch.models.marlin.device import DeviceProver
    from kzg_snark_tpu_torch.models.marlin.verifier import Verifier
    from kzg_snark_tpu_torch.rng import Rng
    from kzg_snark_tpu_torch.utils.fixtures import synthetic_r1cs

    n = 1 << MARLIN_LOG_H
    t0 = time.perf_counter()
    A, B, C, z = synthetic_r1cs(n, curve_type=curve)
    circuit_s = time.perf_counter() - t0
    x, w = z[:MARLIN_PUBLIC], z[MARLIN_PUBLIC:]
    m = len(A.nonzero_positions())
    max_degree = 6 * m
    torch.cuda.reset_peak_memory_stats()
    times = {}

    def run():
        t0 = time.perf_counter()
        keys = DeviceProver(curve, rng=Rng(900), device=dev).preprocess(
            A, B, C, max_degree, tau=MARLIN_TAU)
        torch.cuda.synchronize()
        times["index"] = time.perf_counter() - t0
        prover = DeviceProver(curve, rng=Rng(901), collect_timings=True,
                              device=dev)
        times["prover"] = prover
        times["prove"] = []
        for _ in range(2):
            t0 = time.perf_counter()
            proof = prover.prove(keys[0], x, w)
            torch.cuda.synchronize()
            times["prove"].append(time.perf_counter() - t0)
        return keys, proof

    (ipk, ivk), proof = run_path(torch, paths, name, run)
    counts = paths[name]
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    ok = Verifier(curve, rng=Rng(902)).verify(ivk, x, proof)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError(f"host Marlin Verifier rejected the {curve} "
                             "proof")
    tampered = dict(proof)
    tampered["evaluations"] = dict(proof["evaluations"])
    beta1 = list(proof["evaluations"]["beta1"])
    beta1[0] = beta1[0] + 1
    tampered["evaluations"]["beta1"] = beta1
    if Verifier(curve, rng=Rng(903)).verify(ivk, x, tampered):
        raise AssertionError("host Marlin Verifier accepted a tampered proof")
    check_ntt_passes(name, counts)
    log(f"[{name}] {curve} |H|=2^{MARLIN_LOG_H}, nnz(A)=m={m}, "
        f"max_degree={max_degree}: "
        f"circuit {circuit_s:.3f} s, index {times['index']:.3f} s, prove "
        f"{times['prove'][0]:.3f} s then {times['prove'][1]:.3f} s, host "
        f"verify {verify_s:.3f} s: accepted, tampered rejected")
    phases = {k: round(v * 1e3, 3)
              for k, v in times["prover"].timings.items()}
    log(f"[{name}] phases of the second prove (ms): {json.dumps(phases)}; "
        f"sum {sum(phases.values()):.3f} ms")
    log(f"[{name}] peak device memory {peak} bytes "
        f"({peak / 2 ** 30:.3f} GiB)")
    log(f"[{name}] launches: {json.dumps(counts, sort_keys=True)}")
    log(f"[{name}] launches by width (elements or points): "
        f"{json.dumps(PATH_WIDTHS[name], sort_keys=True)}")
    log(f"[{name}] launches by limb count: "
        f"{json.dumps(PATH_LIMBS[name], sort_keys=True)}")
    return lambda: times["prover"].prove(ipk, x, w)


def profile_run(torch, label, fn):
    """One call of ``fn`` under torch.profiler: wall time, device busy time
    (the union of the card's activity intervals), idle share and the
    largest device times by kernel."""
    wall_ms, spans, prof = trace(torch, fn)
    busy = busy_ms(spans)
    attr = ("self_device_time_total"
            if hasattr(prof.key_averages()[0], "self_device_time_total")
            else "self_cuda_time_total")
    top = sorted(((getattr(k, attr) / 1e3, k.count, k.key)
                  for k in prof.key_averages() if getattr(k, attr) > 0),
                 reverse=True)[:8]
    log(f"[profile] {label}: wall {wall_ms:.3f} ms (profiler on), device "
        f"busy {busy:.3f} ms over {len(spans)} device activities, idle "
        f"share {1 - busy / wall_ms:.4f}; device ms by kernel: "
        + "; ".join(f"{name[:48]} {ms:.3f} ({n})" for ms, n, name in top))


# ---------------------------------------------------------------------------
# The single-device surface: checked mode, the config's NTT mode,
# serialization, Marlin on BLS12-381 and the entry point.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def env_set(**values):
    """The environment variables ``values`` for the block, the old values
    restored after it."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_checked(torch, dev, main):
    """PLONK n = 2^16 (BN254) indexed and proved twice by a fresh prover
    under KZG_TPU_CHECKED=1 with the main path's seeds: the index and both
    proofs byte-identical to the main path's, their seconds beside the
    unchecked ones; then planted faults (``plant_faults``) must trap."""
    from kzg_snark_tpu_torch.models.plonk.device import (DeviceProver,
                                                         PlonkDeviceCore)
    from kzg_snark_tpu_torch.ops.fr import CheckedFieldBackend
    from kzg_snark_tpu_torch.rng import Rng

    n = 1 << MAIN_LOG_N
    qM, qZ, qO, perm, w = main["circuit"]
    t_phase = time.perf_counter()
    with env_set(KZG_TPU_CHECKED="1"):
        prover = DeviceProver("bn254", rng=Rng(77), collect_timings=True,
                              device=dev)
        t0 = time.perf_counter()
        ipk, ivk = prover.preprocess(qM, qZ, qZ, qO, qZ, perm,
                                     max_degree=n + 5, tau=TAU)
        torch.cuda.synchronize()
        index_s = time.perf_counter() - t0
        prove_s, proofs = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            proofs.append(prover.prove(ipk, [], w))
            torch.cuda.synchronize()
            prove_s.append(time.perf_counter() - t0)
        if not isinstance(PlonkDeviceCore("bn254", n, dev).be,
                          CheckedFieldBackend):
            raise AssertionError("KZG_TPU_CHECKED=1 gave an unchecked core")
    if ivk["commitments"] != main["keys"][1]["commitments"]:
        raise AssertionError("the checked index differs from the unchecked")
    for i, (got, want) in enumerate(zip(proofs, main["proofs"])):
        if got != want:
            raise AssertionError(f"checked prove {i + 1} differs from the "
                                 "unchecked one")
    phases = {k: round(v * 1e3, 3) for k, v in prover.timings.items()}
    log(f"[checked] PLONK bn254 n=2^{MAIN_LOG_N} under KZG_TPU_CHECKED=1: "
        f"index and "
        f"both proofs byte-identical to the main path's; index "
        f"{index_s:.3f} s (unchecked {main['index_s']:.3f}), prove "
        f"{prove_s[0]:.3f} then {prove_s[1]:.3f} s (unchecked "
        f"{main['prove_s'][0]:.3f} then {main['prove_s'][1]:.3f}): the "
        f"steady prove {prove_s[1] / main['prove_s'][1]:.3f}x")
    log(f"[checked] phases of the second checked prove (ms): "
        f"{json.dumps(phases)}")
    plant_faults(torch, dev)
    log(f"[checked] phase in {time.perf_counter() - t_phase:.1f} s")


def plant_faults(torch, dev):
    """Under KZG_TPU_CHECKED=1 on the card: an fr_mul whose output has p
    added to one column must trap at "mul", a g1_add whose output holds p
    in one coordinate of one point at "g1.add", each at that column; the
    clean op passes first."""
    from kzg_snark_tpu_torch.ops import cuda_fr
    from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
    from kzg_snark_tpu_torch.ops.fr import fr_backend
    from kzg_snark_tpu_torch.ops.g1 import curve_ops
    from kzg_snark_tpu_torch.ops.limbs import (ints_to_words, to_tensor,
                                               to_words, words_to_ints)

    col, point, m = 4097, 5, 1 << 10

    def words_of(fc, value):
        return to_tensor(ints_to_words([value], fc.num_limbs), dev)[:, 0]

    def mul_plus_p(kernel):
        def planted(fc, a, b):
            out = kernel(fc, a, b)
            v = words_to_ints(to_words(out[:, col:col + 1]))[0]
            out[:, col] = words_of(fc, v + fc.modulus)
            return out
        return planted

    def add_with_p(kernel):
        def planted(fc, p, q):
            out = kernel(fc, p, q)
            out[1, :, point] = words_of(fc, fc.modulus)
            return out
        return planted

    with env_set(KZG_TPU_CHECKED="1"):
        be = fr_backend("bn254", dev)
        a = be.to_mont(random_canonical(torch, 1 << 16, 71, dev))
        b = be.to_mont(random_canonical(torch, 1 << 16, 72, dev))
        curve = curve_ops("bn254", dev)
        pts, _ = random_point_basis("bn254", m, seed=73, device=dev)
        cases = (("fr_mul", mul_plus_p, lambda: be.mul(a, b), "mul", col),
                 ("g1_add", add_with_p,
                  lambda: curve.add(pts, pts.flip(-1)), "g1.add",
                  m + point))
        for name, fault, call, op, column in cases:
            call()
            kernel = getattr(cuda_fr, name)
            setattr(cuda_fr, name, fault(kernel))
            try:
                call()
            except AssertionError as e:
                msg = str(e)
            else:
                raise AssertionError(f"checked mode passed a planted "
                                     f"non-canonical {name} output")
            finally:
                setattr(cuda_fr, name, kernel)
            if not msg.startswith(f"{op}: non-canonical output") or \
                    not msg.endswith(f"at column {column}"):
                raise AssertionError(f"the planted {name} fault trapped "
                                     f"as {msg!r}")
            log(f"[checked] planted {name} fault trapped: {msg[:40]}... "
                f"{msg[-20:]}")


def phase_config(torch, dev, paths):
    """KZG_TPU_NTT_MODE read at call time: with "scan" and no mode
    argument a 2^16 transform and its inverse launch fr_butterfly and no
    ntt_pass (the config_scan path) and equal the staged ones; "unrolled"
    (XLA only) raises."""
    from kzg_snark_tpu_torch.ops.ntt import ntt_context

    t_phase = time.perf_counter()
    n = 1 << MAIN_LOG_N
    ctx = ntt_context("bn254", n, dev)
    x = ctx.backend.to_mont(random_canonical(torch, n, 81, dev))
    want = ctx.ntt(x, mode="staged")
    with env_set(KZG_TPU_NTT_MODE="scan"):
        got, back = run_path(torch, paths, "config_scan",
                             lambda: (ctx.ntt(x), ctx.intt(want)))
    counts = paths["config_scan"]
    if counts.get("ntt_pass", 0) or not counts.get("fr_butterfly", 0):
        raise AssertionError(f"KZG_TPU_NTT_MODE=scan launched {counts}")
    if not torch.equal(got, want) or not torch.equal(back, x):
        raise AssertionError("KZG_TPU_NTT_MODE=scan differs from staged")
    with env_set(KZG_TPU_NTT_MODE="unrolled"):
        try:
            ctx.ntt(x)
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("KZG_TPU_NTT_MODE=unrolled did not raise")
    log(f"[config] KZG_TPU_NTT_MODE=scan, no mode argument: NTT and iNTT "
        f"2^{MAIN_LOG_N} == staged, launches {json.dumps(counts)}; "
        f"unrolled raises: {refused}; phase in "
        f"{time.perf_counter() - t_phase:.1f} s")


def phase_serial(torch, dev, main):
    """Save and load the n = 2^16 SRS as a DeviceSRS, the PLONK index keys
    and a proof: a prove from the loaded keys byte-identical to one from
    the original keys, the loaded proof verified on the host; the seconds
    and file sizes."""
    import tempfile
    from kzg_snark_tpu_torch.models.kzg import KZG
    from kzg_snark_tpu_torch.models.plonk.device import DeviceProver
    from kzg_snark_tpu_torch.models.plonk.verifier import Verifier
    from kzg_snark_tpu_torch.ops.srs import DeviceSRS
    from kzg_snark_tpu_torch.rng import Rng
    from kzg_snark_tpu_torch.utils import serialization as ser

    t_phase = time.perf_counter()
    ipk, ivk = main["keys"]
    w = main["circuit"][-1]
    kzg = KZG("bn254", backend="cuda", device=dev)
    secs = {}

    def timed_call(label, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        secs[label] = round(time.perf_counter() - t0, 3)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        srs, keys, proof_path = (os.path.join(tmp, f) for f in (
            "srs.npz", "keys.npz", "proof.json"))
        timed_call("save_srs", ser.save_srs, srs, kzg, ipk["ck"], ivk["rk"])
        ck, _ = timed_call("load_srs", ser.load_srs, srs, kzg)
        if not isinstance(ck, DeviceSRS) or \
                not torch.equal(ck.points, ipk["ck"].points):
            raise AssertionError("the loaded SRS differs from the saved one")
        timed_call("save_index_keys", ser.save_index_keys, keys, kzg, ipk,
                   ivk)
        ipk2, ivk2 = timed_call("load_index_keys", ser.load_index_keys, keys,
                                kzg)
        proof = DeviceProver("bn254", rng=Rng(502), device=dev).prove(
            ipk, [], w)
        loaded_proof = DeviceProver("bn254", rng=Rng(502), device=dev).prove(
            ipk2, [], w)
        if loaded_proof != proof or ivk2["commitments"] != ivk["commitments"]:
            raise AssertionError("a prove from the loaded keys differs from "
                                 "one from the original keys")
        timed_call("save_proof", ser.save_proof, proof_path, loaded_proof)
        back = timed_call("load_proof", ser.load_proof, proof_path, kzg)
        if back != proof or not Verifier("bn254", rng=Rng(503)).verify(
                ivk2, [], back):
            raise AssertionError("the loaded proof does not verify")
        sizes = {f: os.path.getsize(os.path.join(tmp, f))
                 for f in sorted(os.listdir(tmp))}
    log(f"[serial] n=2^{MAIN_LOG_N} SRS (DeviceSRS), PLONK index keys and "
        f"proof saved and loaded: a prove from the loaded keys byte-identical, the "
        f"loaded proof verified; seconds {json.dumps(secs)}; bytes "
        f"{json.dumps(sizes)}; phase in {time.perf_counter() - t_phase:.1f} "
        f"s")


def phase_bls_marlin(torch, dev, paths):
    """Marlin on BLS12-381: at |H| = 2^6 (bls_marlin_parity, as the
    marlin_parity phase) the commits on the ladder and the scan MSM at 12
    words; at |H| = 2^14 (bls_marlin) index, two proves, host
    verification, tamper rejection, the phase map and the launches, the
    bucket MSM and the SRS table at 12 words."""
    t_phase = time.perf_counter()
    phase_marlin_parity(torch, dev, paths, "bls12_381", "bls_marlin_parity")
    check_limbs("bls_marlin_parity", ("g1_ladder", "g1_add_mixed"))
    log(f"[bls_marlin_parity] launches by limb count "
        f"{json.dumps(PATH_LIMBS['bls_marlin_parity'], sort_keys=True)}")
    phase_marlin(torch, dev, paths, "bls12_381", "bls_marlin")
    check_limbs("bls_marlin", ("msm_accumulate", "msm_reduce",
                               "g1_fixed_base_table"))
    log(f"[bls_marlin] phase in {time.perf_counter() - t_phase:.1f} s")


def check_limbs(name: str, kernels) -> None:
    """Each of ``kernels`` launched at 12 words (BLS12-381 Fq) on the path
    ``name``."""
    for kernel in kernels:
        if not PATH_LIMBS[name].get(kernel, {}).get(12, 0):
            raise AssertionError(f"the {name} path launched {kernel} at no "
                                 f"12-word width: {PATH_LIMBS[name]}")


def phase_entry():
    """``python -m kzg_snark_tpu_torch --synthetic 6 --seed 7 --timing`` on
    the card, then again with KZG_TPU_CHECKED=1: exit 0, three PASS lines
    and the timing report."""
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "kzg_snark_tpu_torch", *ENTRY_ARGS]
    for label, extra in (("unchecked", {}), ("checked",
                                             {"KZG_TPU_CHECKED": "1"})):
        env = dict(os.environ, **extra)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (here, os.environ.get("PYTHONPATH")) if p)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                              text=True, timeout=300)
        wall = time.perf_counter() - t0
        out = proc.stdout
        if proc.returncode != 0 or out.count("verification: PASS") != 3 \
                or "Timing report:" not in out:
            raise AssertionError(f"the entry point ({label}) exited "
                                 f"{proc.returncode}: {out[-2000:]} "
                                 f"{proc.stderr[-2000:]}")
        report = json.loads(out.split("Timing report:\n", 1)[1].rsplit(
            "Demo complete!", 1)[0])
        log(f"[entry] {label}: {' '.join(cmd[1:])}: exit 0, three PASS, "
            f"{wall:.1f} s wall; demo seconds "
            f"{json.dumps({k: v['total_s'] for k, v in report.items()})}")
    log(f"[entry] phase in {time.perf_counter() - t_phase:.1f} s")


DIST_LOG_N = 20            # the distributed NTT's n, BN254
DIST_LOG_MSM = 20          # the distributed MSM's points, BN254
DIST_LOG_SMALL = 10        # msm_small's points
DIST_BLS_LOG = 16          # the BLS12-381 NTT's n and MSM's points
DIST_LAUNCHES: dict = {}   # dist phase -> {kernel: rank 0's launches}
# Kernels each dist phase must launch (fr_butterfly and the fold's g1_add
# need more than one rank).
DIST_KERNELS = ("fr_mul", "ntt_pass", "g1_add_mixed", "g1_ladder",
                "msm_accumulate", "msm_reduce")


def phase_dist(torch, name: str, ranks: int, backend: str, hosts=None,
               bls=None) -> None:
    """The multi-device path (``kzg_snark_tpu_torch/parallel``) on
    ``ranks`` spawned ranks of this card over ``backend``: the dry run's
    checks (``parallel/dryrun.dryrun_target``: the four-step NTT and its
    round trip equal to the single-device transform, the ``small``
    fallback, the MSM against the host oracle and the single-device MSM,
    the scan-route shards, ``msm_small``; with ``hosts`` the (host, chip)
    mesh's ``msm_multihost`` and two-axis NTT; with ``bls`` the NTT and
    MSM on BLS12-381).  Prints each rank's device and wall ms a call, the
    collectives' ms and bytes, ``collective_stats``, rank 0's launches a
    check and its single-device ms; ranks sharing one card time-share it,
    so their times are no scaling result."""
    from kzg_snark_tpu_torch.ops.ntt_stage import pass_plan, tile_bits
    from kzg_snark_tpu_torch.parallel import dryrun

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    opts = {"log2n": DIST_LOG_N, "log2msm": DIST_LOG_MSM,
            "log2small": DIST_LOG_SMALL, "hosts": hosts, "bls": bls}
    recs = dryrun.launch(dryrun.dryrun_target, ranks, (opts,),
                         backend=backend, device="cuda")
    shared = " (ranks time-share one card: no scaling result)" \
        if ranks > 1 else ""
    checks = [k for k in recs[0] if isinstance(recs[0][k], dict)]
    total: collections.Counter = collections.Counter()
    for check in checks:
        first = recs[0][check]
        calls = [k for k in ("ntt", "intt", "msm") if k in first]
        for call in calls:
            rows = "; ".join(
                f"rank {r['rank']} {r[check][call]['device_ms']:.3f} / "
                f"{r[check][call]['wall_ms']:.3f}" for r in recs)
            log(f"[{name}] {check} {call}: device ms / wall ms{shared}: "
                f"{rows}; collectives "
                f"{json.dumps(first[call]['collectives'])}")
            log(f"[{name}] {check} {call}: rank 0 launches "
                f"{json.dumps(first[call]['launches'], sort_keys=True)}")
            total.update(first[call]["launches"])
        if "collective" in first:
            c = first["collective"]
            log(f"[{name}] {check}: the collective alone "
                f"{json.dumps(c['collectives'])}: device / wall ms "
                f"{c['device_ms']:.4f} / {c['wall_ms']:.4f} (rank 0)")
        if first.get("stats"):
            log(f"[{name}] {check}: collective_stats "
                f"{json.dumps(first['stats'])}")
        if first.get("single_device"):
            sd = first["single_device"]
            log(f"[{name}] {check}: single-device (rank 0, the other ranks "
                f"waiting) device / wall ms {sd['device_ms']:.3f} / "
                f"{sd['wall_ms']:.3f}")
    fwd = recs[0]["ntt"]
    n2 = (1 << DIST_LOG_N) // ranks
    want = {"ntt_pass": len(pass_plan(n2, tile_bits())),
            "fr_butterfly": ranks.bit_length() - 1}
    got = {k: fwd["ntt"]["launches"].get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"[{name}] one distributed transform "
                             f"launched {got}, expected {want}")
    need = DIST_KERNELS + (("fr_butterfly", "g1_add") if ranks > 1
                           else ())
    missing = [k for k in need if not total.get(k)]
    if missing:
        raise AssertionError(f"[{name}] the dist path launched no {missing}")
    DIST_LAUNCHES[name] = dict(total)
    log(f"[{name}] one transform at n = 2^{DIST_LOG_N} over {ranks} ranks: "
        f"{json.dumps(got)} (the column step's plan at 2^"
        f"{n2.bit_length() - 1}, log2 D butterflies); the dist path's "
        f"launches (rank 0, every check's calls) "
        f"{json.dumps(dict(sorted(total.items())))}")
    log(f"[{name}] {ranks} ranks over {backend}: every check passed in "
        f"{time.perf_counter() - t0:.1f} s")


def tree_times(root: str) -> dict:
    """``curve_rows`` (K6, K7 and K9 at 2^16 points) and one small MSM (n =
    256, k = 1, held to the host oracle) on both curves, device and wall
    ms, and the launches of the two parity paths' device runs, with the
    package of the checkout at ``root``, a directory inside this one (an
    earlier tree unpacked under a gitignored directory; public entry
    points only, so such a tree runs too)."""
    import random
    import torch
    here = os.path.dirname(os.path.realpath(__file__))
    root = os.path.realpath(root)
    if os.path.commonpath([root, here]) != here or not os.path.isdir(
            os.path.join(root, "kzg_snark_tpu_torch")):
        raise SystemExit(f"chip_smoke: --tree {root}: not a checkout inside "
                         f"{here}")
    sys.path.insert(0, root)
    from kzg_snark_tpu_torch import constants as C
    from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
    from kzg_snark_tpu_torch.ops.fr import fq_backend
    from kzg_snark_tpu_torch.ops.g1 import generator
    from kzg_snark_tpu_torch.ops.host import curve as hc
    from kzg_snark_tpu_torch.ops.host.field import base_field
    from kzg_snark_tpu_torch.ops.msm import msm_context
    from kzg_snark_tpu_torch.utils.build import (launch_counts,
                                                 reset_launches)

    dev = torch.device("cuda", 0)
    rates = device_rates(torch)
    out = {"root": root}
    for curve in ("bn254", "bls12_381"):
        pts, ks = random_point_basis(curve, 1 << MAIN_LOG_N, seed=5,
                                     device=dev)
        rows: dict = {}
        curve_rows(torch, rates, fq_backend(curve, dev), pts,
                   lambda name, *a: compare(torch, name, rows, *a,
                                            plain_reps=1))
        n = LADDER_SIZES[-1]
        r = C.BN254_R if curve == "bn254" else C.BLS12_381_R
        rng = random.Random(91)
        ints = [rng.randrange(r) for _ in range(n)]
        ctx = msm_context(curve, dev)
        p = pts[..., :n].contiguous()
        sc = ctx.scalars_to_limbs(ints)
        torch.cuda.synchronize()
        reset_launches()
        got = ctx.curve.to_affine_ints(ctx.msm(p, sc))[0]
        launches = launch_counts()
        Fp = base_field(curve)
        gx, gy = generator(curve)
        want = hc.normalize(hc.multiply(
            (Fp(gx), Fp(gy), Fp(1)),
            sum(s_ * k_ for s_, k_ in zip(ints, ks)) % r))
        if got != (int(want[0]), int(want[1])):
            raise AssertionError(f"{curve} small MSM differs from the host "
                                 f"oracle")
        out[curve] = {"2^16_points_ms": {k_: v["ms"] for k_, v in
                                         rows.items()},
                      "small_msm_n256_k1_ms": timed_ms(
                          torch, lambda: ctx.msm(p, sc), 10),
                      "small_msm_launches": launches}
    for name, fn in (("marlin_parity", marlin_parity_device),
                     ("bls_parity", lambda d: plonk_parity_device(
                         d, "bls12_381"))):
        torch.cuda.synchronize()
        reset_launches()
        fn(dev)
        torch.cuda.synchronize()
        out[name] = launch_counts()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--tree"]:
        print(json.dumps({"tree_times": tree_times(sys.argv[2])}), flush=True)
        return 0
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kzg_snark_tpu_torch.utils.build import (build_cuda, cuda_lib,
                                                 kernel_resources)
    count_transforms()

    dev = torch.device("cuda", 0)
    smi_name = smi("name,power.limit")
    rates = device_rates(torch)
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi_name}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{rates['sms']} SMs, max SM clock {rates['clock_mhz']:.0f} MHz: "
        f"bounds at {rates['bytes'] / 1e12:.2f} TB/s and "
        f"{rates['products'] / 1e12:.3f} T 32-bit products/s")
    t0 = time.perf_counter()
    lib_path = build_cuda()
    cuda_lib()
    log(f"[build] {lib_path} in {time.perf_counter() - t0:.2f} s")
    resources = kernel_resources(lib_path)
    for name, res in sorted(resources.items()):
        log(f"[build] {json.dumps(res, sort_keys=True)} {name}")
    curve_occupancy(torch, resources, rates)
    product_sass(lib_path)
    product_throughput(torch, dev, rates)
    product_latency(torch, dev)

    results: dict = {}
    paths: dict = {}
    phase_kernels(torch, dev, results, rates)
    phase_chains(torch, dev, results, rates)
    phase_ntt(torch, dev, paths, rates)
    phase_msm(torch, dev, paths, rates)
    phase_msm_prepared(torch, dev, paths)
    phase_parity(dev)
    main_run = phase_main(torch, dev, paths)
    phase_checked(torch, dev, main_run)
    phase_config(torch, dev, paths)
    phase_serial(torch, dev, main_run)
    del main_run
    phase_marlin_parity(torch, dev, paths)
    marlin_prove = phase_marlin(torch, dev, paths)
    profile_run(torch, "Marlin |H|=2^14 steady prove", marlin_prove)
    bls_rows: dict = {}
    phase_bls(torch, dev, paths, rates, bls_rows)
    phase_bls_marlin(torch, dev, paths)
    phase_entry()
    phase_dist(torch, "dist_nccl", 1, "nccl")
    phase_dist(torch, "dist_gloo4", 4, "gloo", hosts=2, bls=DIST_BLS_LOG)

    kernels = []
    for name, (src, rep, path) in KERNELS.items():
        launches = paths[path].get(name, 0)
        bls_path = BLS_PATHS[name]
        bls_launches = paths[bls_path].get(name, 0)
        if name in OFF_PATH:
            if launches or bls_launches:
                raise AssertionError(f"kernel {name} launched on the {path} "
                                     f"or the {bls_path} path")
        elif launches == 0 or bls_launches == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{path} or the {bls_path} path")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "path": path, "launches": launches,
                        **results[name],
                        "dist_launches": {p: DIST_LAUNCHES[p].get(name, 0)
                                          for p in DIST_LAUNCHES},
                        "prepared_launches": {
                            p: paths[p].get(name, 0) for p in
                            ("msm_prepared", "msm_prepared_split")},
                        "held_at": ["bn254"] + [
                            f"bls12_381 {r_['field']}" for r_ in
                            bls_rows[name]],
                        "bls12_381": {"path": bls_path,
                                      "launches": bls_launches,
                                      "by_limbs": PATH_LIMBS[bls_path].get(
                                          name, {}),
                                      "rows": bls_rows[name]}})
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
