"""The port's spans and its count of the host's waits on the card.

``utils/profiling.span`` is one shared no-op while no torch profiler
records, and a ``record_function`` range while one does, so the port's
steps (``msm.*``, ``kzg.*``, ``ntt.*``, ``g1.to_affine``, ``fr.*``,
``plonk.*``, ``marlin.*``) land in the profiler's Chrome trace inside
whatever range the caller has open.  ``utils/build.count_sync`` counts
each wait where the port makes it, on any device, so a CPU run pins what
a batch on the card waits for; ``reset_launches`` zeroes it.  The
benchmark's readers of the new metrics (``msm_schedule_ms``,
``msm_idle_ms``, ``syncs_per_batch``) read the hand-made trace below, and
a batch of each cell opens few enough port spans that
``kzgbench/trace.py``'s walk back over 64 spans still finds every harness
span.  On the card (``cuda``): under ``torch.cuda.set_sync_debug_mode``
every wait of a batch of each cell at its real size comes from a line
that counts it.
"""

import importlib
import json
import linecache
import os
import random
import traceback
import warnings
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kzg_snark_tpu_torch.models.marlin.device import DeviceProver as Marlin
from kzg_snark_tpu_torch.models.plonk.device import (DeviceProver as Plonk,
                                                     PlonkDeviceCore)
from kzg_snark_tpu_torch.ops import msm as msm_mod
from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
from kzg_snark_tpu_torch.ops.host.field import scalar_field
from kzg_snark_tpu_torch.ops.limbs import ints_to_words, to_tensor
from kzg_snark_tpu_torch.ops.msm_kernel import FusedMsm
from kzg_snark_tpu_torch.rng import Rng
from kzg_snark_tpu_torch.utils import build, profiling
from kzgbench import harness, trace
from kzgbench.metrics import msm_idle_ms, msm_schedule_ms, syncs_per_batch
from kzgbench.plain.curves import CURVES
from kzgbench.plain.reference import Reference
from kzgbench.plain.transcript import tau_from_seed

torch.set_num_threads(1)

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
TINY = {"config": {"n": 8}, "traffic": {"batch": 2, "pool_batches": 2,
                                        "warmup_batches": 1}}
SEED = 2 ** 31 + 17
# Names of the harness's spans, which its readers select by prefix.
HARNESS = ("commit.", "intt", "open", "host.", "cell_proofs",
           trace.BATCH_SPAN, "warmup.batch")
# The waits of one batch: each of the two MSMs 1 in the schedule (the
# chunk total, the busiest window and the entry count, read together) and
# 3 in the affine conversion (x and y to the host, the identity flags);
# the openings' scalars to the card; the evaluations to the host.
MSM_SYNCS = {"msm.tolist": 1}
BATCH_SYNCS = {
    "blob4844.b9": {"msm.tolist": 2, "g1.to_affine_ints": 2,
                    "limbs.to_words": 5, "limbs.to_tensor": 1},
    "kzg2e20.b8": {"msm.tolist": 2, "g1.to_affine_ints": 2,
                   "limbs.to_words": 5, "limbs.to_tensor": 2},
    # The commitments' MSM; the proofs' affine conversion; the cells to the
    # host.  FK20's grouped MSMs wait for nothing.
    "peerdas.b9": {"msm.tolist": 1, "g1.to_affine_ints": 2,
                   "limbs.to_words": 5},
}
# The port's spans each protocol's batch must open.
PROTOCOL_SPANS = {
    "blob": {"msm.schedule", "msm.accumulate", "kzg.open", "ntt.intt",
             "g1.to_affine"},
    "multi_open": {"msm.schedule", "msm.accumulate", "kzg.open", "ntt.intt",
                   "g1.to_affine"},
    "cells": {"msm.schedule", "msm.accumulate", "ntt.intt", "g1.to_affine",
              "fk20.extend", "fk20.columns", "fk20.msm", "fk20.g1_dft"},
}
PLONK_PHASES = ["setup", "round1_wires", "round1_commits_msm",
                "round2_grand_product", "round2_commit_msm",
                "round3_quotient_ntt", "round3_commits_msm", "round4_evals",
                "round5_openings"]
MARLIN_PHASES = ["index_cache", "witness_and_matvecs", "masks_and_h0",
                 "round1_commits", "t_and_sumcheck1", "round2_commits",
                 "sumcheck2", "round3_commits", "linearization_and_evals",
                 "openings"]


def _annotations(path) -> list:
    """(name, start, end) of every ``record_function`` range of a Chrome
    trace, by start."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events
              if e.get("ph") == "X" and e.get("cat") == trace.SPAN_CAT]
    return sorted(ranges, key=lambda r: (r[1], -r[2]))


def _profiled(fn, path):
    """fn() under a CPU torch profiler; its Chrome trace to ``path``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    return out


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name))
    a, b = profiling.span("msm.schedule"), profiling.span("kzg.open")
    assert a is b is profiling._NO_SPAN
    with a:
        pass
    assert made == []


def test_span_under_a_profiler_is_a_range(tmp_path):
    def run():
        with profiling.span("kzg.eval"):
            torch.ones(4).cumsum(0)
    _profiled(run, tmp_path / "t.json")
    assert [a[0] for a in _annotations(tmp_path / "t.json")] == ["kzg.eval"]


@pytest.fixture(scope="module")
def msm_run(tmp_path_factory):
    """One FusedMsm call at n = 2048 and a PlonkDeviceCore opening, inside
    an outer range under the profiler, with the MSM's waits."""
    pts, _ = random_point_basis("bn254", 64, seed=3, device="cpu")
    points = pts.repeat(1, 1, 32)                   # repeated: complete adds
    fused = FusedMsm("bn254", "cpu")
    r = fused.scalar_backend.modulus
    rng = random.Random(5)
    scalars = to_tensor(ints_to_words([rng.randrange(r)
                                       for _ in range(2048)]), "cpu")
    core = PlonkDeviceCore("bn254", 16, "cpu")
    be = core.be
    coeffs = be.from_ints([rng.randrange(r) for _ in range(16)])
    z, w = be.scalar(rng.randrange(r)), be.scalar(rng.randrange(r))
    path = tmp_path_factory.mktemp("msm") / "trace.json"
    build.reset_launches()

    def run():
        with torch.profiler.record_function("outer"):
            fused.msm(points, scalars, complete=True)
            msm_syncs = build.sync_counts()
            core.eval_dev(coeffs, z)
            core.open_dev(core.combine_weighted([coeffs, coeffs], [w, w]), z)
        return msm_syncs
    msm_syncs = _profiled(run, path)
    return msm_syncs, _annotations(path)


def test_msm_and_kzg_spans_nest_in_the_callers_range(msm_run):
    _, spans = msm_run
    (outer,) = [s for s in spans if s[0] == "outer"]
    inner = [s for s in spans if s[0] != "outer"]
    steps = {"msm.table", "msm.schedule", "msm.accumulate", "msm.reduce",
             "kzg.eval", "kzg.open", "kzg.combine"}
    names = {s[0] for s in inner}
    assert steps <= names and all(s.startswith("fr.") for s in names - steps)
    assert all(outer[1] <= a and b <= outer[2] for _, a, b in inner)
    msm = [s[0] for s in inner if s[0].startswith("msm.")]
    assert msm == ["msm.table", "msm.schedule", "msm.accumulate",
                   "msm.reduce"]


def test_fused_msm_counts_its_waits_and_reset_zeroes_them(msm_run):
    msm_syncs, _ = msm_run
    assert msm_syncs == MSM_SYNCS
    build.count_sync("limbs.to_words")
    assert build.sync_counts()["limbs.to_words"] >= 1
    build.reset_launches()
    assert build.sync_counts() == {}


class _Ranges:
    """A stand-in for ``torch.profiler.record_function`` that logs the
    names of the ranges entered, for ``span`` to return while
    ``profiling._recording`` is patched to say a profiler records."""

    def __init__(self, log):
        self.log = log

    def __call__(self, name):
        self.log.append(name)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def ranges(monkeypatch):
    log = []
    monkeypatch.setattr(profiling, "_recording", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", _Ranges(log))
    return log


def test_plonk_prove_with_timings_off_passes_no_phase_sync(ranges):
    n = 8
    Fr = scalar_field("bn254")
    one, zero = Fr(1), Fr(0)
    a = [Fr(i + 2) for i in range(n)]
    b = [Fr(i + 3) for i in range(n)]
    c = [x * y for x, y in zip(a, b)]
    ipk, _ = Plonk("bn254", rng=Rng(600), device="cpu").preprocess(
        [one] * n, [zero] * n, [zero] * n, [-one] * n, [zero] * n,
        list(range(3 * n)), max_degree=n + 5, tau=0xABCDEF)
    build.reset_launches()
    del ranges[:]
    prover = Plonk("bn254", rng=Rng(601), device="cpu")
    prover.prove(ipk, [], a + b + c)
    assert "plonk.phase" not in build.sync_counts()
    assert prover.timings == {}
    assert [r for r in ranges if r.startswith("plonk.")] == \
        [f"plonk.{p}" for p in PLONK_PHASES]
    assert {r.split(".")[0] for r in ranges} <= {"plonk", "kzg", "msm",
                                                 "ntt", "g1", "fr"}


@pytest.mark.parametrize("prover, layer", [(Plonk, "plonk"),
                                           (Marlin, "marlin")])
def test_a_phase_syncs_and_is_timed_only_with_timings_on(prover, layer,
                                                         ranges):
    build.reset_launches()
    quiet = prover("bn254", device="cpu")
    with quiet._phase("round"):
        pass
    assert build.sync_counts() == {} and quiet.timings == {}
    timed = prover("bn254", device="cpu", collect_timings=True)
    for _ in range(2):
        with timed._phase("round"):
            pass
    assert build.sync_counts() == {f"{layer}.phase": 2}
    assert list(timed.timings) == ["round"] and timed.timings["round"] >= 0
    assert ranges == [f"{layer}.round"] * 3


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 7 if cat == "kernel" else 1, "args": args}


def _hand_made(tmp_path, port: bool) -> str:
    """One batch: ``commit.polys`` holding 32 port spans, each with one
    launch and a 4-us kernel (every fourth span ``g1.to_affine``, the rest
    ``msm.schedule``, ``msm.accumulate``, ``msm.reduce`` in turn), then a
    launch of its own; ``open`` with one launch."""
    ev = [_x("user_annotation", trace.BATCH_SPAN, 100, 1000),
          _x("user_annotation", "commit.polys", 110, 490),
          _x("user_annotation", "open", 600, 400)]
    names = ["msm.schedule", "msm.accumulate", "msm.reduce", "g1.to_affine"]
    for i in range(32):
        a = 120 + 12 * i
        if port:
            ev.append(_x("user_annotation", names[i % 4], a, 11))
        ev += [_x("cuda_runtime", "cudaLaunchKernel", a + 1, 1,
                  correlation=i + 1),
               _x("kernel", f"void k{i}(int)", a + 2, 4, correlation=i + 1)]
    ev += [_x("cuda_runtime", "cudaLaunchKernel", 520, 1, correlation=100),
           _x("kernel", "void k_last(int)", 525, 20, correlation=100),
           _x("cuda_runtime", "cudaLaunchKernel", 610, 1, correlation=101),
           _x("kernel", "void k_open(int)", 620, 80, correlation=101)]
    path = tmp_path / f"port{int(port)}.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_32_port_spans_leave_the_harness_spans_and_feed_the_readers(
        tmp_path):
    bare = trace.summarize(_hand_made(tmp_path, False))
    full = trace.summarize(_hand_made(tmp_path, True))
    assert bare["span_device_us"] == {trace.BATCH_SPAN: 228,
                                      "commit.polys": 148, "open": 80}
    assert {k: v for k, v in full["span_device_us"].items()
            if k.startswith(HARNESS)} == bare["span_device_us"]
    # Kernels in the 8 msm.schedule spans: 4 us each.
    assert full["span_device_us"]["msm.schedule"] == 32
    # The 8-us gap after each of the first 31 spans' kernels sits in that
    # span: 24 of them in msm.* spans, 7 in g1.to_affine.
    assert full["idle_by_span_us"]["g1.to_affine"] == 56
    record = SimpleNamespace(trace=full, batches=[(0.0, 1e-3, 2)])
    assert msm_schedule_ms.read(record) == pytest.approx(0.032)
    assert msm_idle_ms.read(record) == pytest.approx(0.192)
    record.trace = bare                             # a program without spans
    assert msm_schedule_ms.read(record) is None
    assert msm_idle_ms.read(record) is None


def test_syncs_per_batch_reads_the_counter(monkeypatch):
    build.reset_launches()
    build.count_sync("msm.tolist", 2)
    build.count_sync("limbs.to_words")
    record = SimpleNamespace(batches=[(0.0, 1.0, 9), (1.0, 2.0, 9)])
    assert syncs_per_batch.read(record) == 1.5
    build.reset_launches()
    assert syncs_per_batch.read(record) == 0.0
    monkeypatch.delattr(build, "sync_counts")        # a program without it
    assert syncs_per_batch.read(record) is None


def _cell(name: str, device, resize=None):
    """The cell's protocol Cell (its own Spans) and configuration."""
    _, config, traffic = harness.load_cell(name)
    if resize:
        config = {**config, **resize["config"]}
        traffic = {**traffic, **resize["traffic"]}
    proto = importlib.import_module(
        f"kzgbench.protocols.{config['protocol']}")
    tau = tau_from_seed(SEED, CURVES[config["curve"]].r)
    spans = harness.Spans()
    cell = proto.Cell(config, traffic, SEED, tau, device, spans)
    return cell, spans, config, tau


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_batch_opens_few_port_spans_and_pins_its_waits(
        cell, tmp_path, monkeypatch):
    # The bucket route at n = 8, as the cells take it at their real sizes.
    monkeypatch.setattr(msm_mod, "FUSED_THRESHOLD", 2)
    c, spans, config, tau = _cell(cell, torch.device("cpu"), TINY)
    c.run_batch(1)
    build.reset_launches()

    def run():
        spans.recording = True
        with spans(trace.BATCH_SPAN):
            out = c.run_batch(0)
        spans.recording = False
        return out
    out = _profiled(run, tmp_path / "t.json")
    assert build.sync_counts() == BATCH_SYNCS[cell]
    plain = importlib.import_module(f"kzgbench.plain.{config['protocol']}")
    want = plain.expected(Reference(c.curve, c.n, tau), c.pool_words(0))
    counts = harness.compare([(0, out)], {0: want})
    assert all(wrong == 0 for _, wrong in counts.values())

    ranges = _annotations(tmp_path / "t.json")
    port = [s for s in ranges if not s[0].startswith(HARNESS)]
    assert port and all(s[0].split(".")[0] in ("msm", "kzg", "ntt", "g1",
                                                "fr", "fk20") for s in port)
    assert PROTOCOL_SPANS[config["protocol"]] <= {s[0] for s in port}
    (batch,) = [s for s in ranges if s[0] == trace.BATCH_SPAN]
    # Every span of the batch lies within the walk back from its end.
    assert sum(batch[1] <= s[1] <= batch[2] for s in ranges) < 64
    for name, a, b in ranges:
        if name.startswith(HARNESS) and name != trace.BATCH_SPAN:
            assert sum(a <= s[1] <= b for s in port) <= 32, name


def _uncounted(stack) -> bool:
    """Whether the innermost frame of the port in ``stack`` does not count
    a wait on its line or the three before."""
    for frame in reversed(stack):
        if f"{os.sep}kzg_snark_tpu_torch{os.sep}" in frame.filename:
            lines = [linecache.getline(frame.filename, k)
                     for k in range(frame.lineno - 3, frame.lineno + 1)]
            return not any("count_sync(" in line for line in lines)
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_every_wait_of_a_card_batch_is_counted(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda", 0)
    c, _, _, _ = _cell(cell, dev)
    for slot in range(2):                       # caches and builds first
        c.run_batch(slot)
    torch.cuda.synchronize(dev)
    build.reset_launches()
    waits = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            waits.append((f"{filename}:{lineno}",
                          traceback.extract_stack()))
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            c.run_batch(0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where = sorted({w for w, _ in waits})
    print(f"{cell}: {len(waits)} warned waits at {where}; counted "
          f"{build.sync_counts()}")
    assert build.sync_counts() == BATCH_SYNCS[cell]
    # The accumulate's route (ops/msm_kernel.accumulate_run): both 2^20
    # MSM calls of a batch take the range route, no blob cell's call does.
    routes = build.msm_route_counts()
    print(f"{cell}: MSM routes {routes}")
    if cell == "kzg2e20.b8":
        assert set(routes) == {"ranges"} and routes["ranges"]["calls"] == 2
    else:
        assert set(routes) == {"chunks"}
    assert waits
    assert [[f"{f.filename}:{f.lineno} {f.name}" for f in stack[-6:]]
            for _, stack in waits if _uncounted(stack)] == []
