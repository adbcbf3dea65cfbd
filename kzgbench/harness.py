"""One run of one cell: set-up, warm-up, the measured window, the check.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``; its configuration in the file that names; its traffic in
``kzgbench/traffic/<traffic>.json``; the protocol the configuration names in
``kzgbench/protocols/<protocol>.py`` (the program's side, the only code
that imports the port) and ``kzgbench/plain/<protocol>.py`` (its plain
reference); each metric's reader in ``kzgbench/metrics/<metric>.py``, with
dots and dashes of the name as underscores (``reader``).

The loop is closed with one client: a batch is submitted when the last one's
answers are on the host.  Inputs are a pool of batches made on the device
from the seed in set-up and used in turn; every answer of the window is
compared with the reference's answer for its batch of the pool.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import statistics
import sys
import time
from contextlib import contextmanager
from types import SimpleNamespace

import torch

from . import trace as trace_mod
from .plain.curves import CURVES
from .plain.reference import Reference
from .plain.transcript import tau_from_seed

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
TRACE_DIR = os.path.join(ROOT, ".kzgbench", "trace")
FORBIDDEN = ("jax", "jaxlib", "flax", "kzg_snark_tpu")
ANSWERS = ("commitments", "evaluations", "proofs")


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def module_name(metric: str) -> str:
    return metric.replace(".", "_").replace("-", "_")


def reader(metric: str):
    """The reader module of ``metric``: ``metrics/<module_name>.py``, or,
    where there is none, the reader of the name before its last dot, so
    that a quantity split by the end-to-end metric it moves
    (``open_ms.blob`` beside ``open_ms``) is read by one file."""
    name = metric
    while True:
        try:
            return importlib.import_module(
                f"kzgbench.metrics.{module_name(name)}")
        except ModuleNotFoundError as exc:
            if exc.name != f"kzgbench.metrics.{module_name(name)}" \
                    or "." not in name:
                raise
            name = name.rsplit(".", 1)[0]


def load_cell(name: str, bench: dict | None = None):
    """(workload entry, configuration, traffic) of the cell ``name``."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, conf["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(PKG, "traffic", cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    return cell, config, traffic


def cell_metrics(name: str, traced: bool, bench: dict | None = None) -> list:
    """The metric entries a run of cell ``name`` reports: its end-to-end
    metrics untraced, its per-layer metrics traced."""
    bench = bench or benchmark()
    kind = "per_layer" if traced else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Spans:
    """Host spans around the calls into each layer: wall seconds by name,
    and a ``record_function`` range while the profiler records."""

    def __init__(self):
        self.totals: dict = {}
        self.recording = False

    def reset(self) -> None:
        self.totals = {}

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.recording:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.totals[name] = self.totals.get(name, 0.0) + \
            time.perf_counter() - t0


def compare(outputs: list, expected: dict) -> dict:
    """Answers of the window against the reference's: per kind, the number
    compared and the number wrong (a missing answer is wrong)."""
    counts = {kind: [0, 0] for kind in ANSWERS}
    for slot, out in outputs:
        want = expected[slot]
        for kind in ANSWERS:
            got = out.get(kind) if out else None
            exp = want[kind]
            counts[kind][0] += len(exp)
            for i, e in enumerate(exp):
                if got is None or i >= len(got) or got[i] != e:
                    counts[kind][1] += 1
    return counts


def _window(cell, spans: Spans, slots: int, seconds: float, prof,
            traced_batches: int):
    """The measured window: batches of the pool in turn, each waited for,
    until ``seconds`` have passed; the profiler (if any) stops after
    ``traced_batches``.  -> (outputs, batches as (start, end, polys) from
    the window's start, failed polynomials, errors, window seconds)."""
    outputs, batches, failed, errors = [], [], 0, []
    start = time.perf_counter()
    b = 0
    while True:
        slot = b % slots
        t1 = time.perf_counter()
        try:
            with spans(trace_mod.BATCH_SPAN):
                out = cell.run_batch(slot)
        except (RuntimeError, ValueError) as exc:
            out = None
            failed += cell.batch
            errors.append(repr(exc))
        t2 = time.perf_counter()
        outputs.append((slot, out))
        batches.append((t1 - start, t2 - start, cell.batch))
        b += 1
        if prof is not None and b == traced_batches:
            spans.recording = False
            prof.stop()
        if t2 - start >= seconds:
            return outputs, batches, failed, errors, \
                time.perf_counter() - start


def _export_trace(prof, spans: Spans, workload: str, host_spans: dict,
                  batches: list) -> dict:
    """Stop the profiler if it still records, write its Chrome trace and
    the host spans under the checkout's ``.kzgbench/trace/``, and read the
    trace (``trace.summarize``)."""
    if spans.recording:
        spans.recording = False
        prof.stop()
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, f"{workload}.trace.json")
    prof.export_chrome_trace(path)
    with open(os.path.join(TRACE_DIR, f"{workload}.spans.json"), "w") as fh:
        json.dump({"host_span_s": host_spans, "batches": batches}, fh)
    return trace_mod.summarize(path)


def read_metrics(record, entries: list) -> dict:
    """Each entry's reader (``kzgbench/metrics/<name>.py``) on the record;
    a metric whose reader finds nothing is left out."""
    metrics = {}
    for m in entries:
        value = reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def run(workload: str, seed: int, seconds: float, traced: bool,
        device: torch.device, t0: float, plant=None,
        resize: dict | None = None, marks: dict | None = None) -> dict:
    """One run -> {"line": the result's fields, "checks": the numbers
    compared with their limits, "notes": lines for standard error}.

    ``plant`` (controls and tests only) is called with the cell after the
    warm-up, to break the timed path underneath, and returns the undo,
    called when the window closes.  ``resize`` (CPU tests only) updates
    the configuration's and the traffic's sizes: {"config": {...},
    "traffic": {...}}.  ``marks`` (the command's) splits the seconds
    before this call by what they went to, for the set-up's note."""
    t_run = time.perf_counter()
    bench = benchmark()
    cell_entry, config, traffic = load_cell(workload, bench)
    if resize:
        config = {**config, **resize.get("config", {})}
        traffic = {**traffic, **resize.get("traffic", {})}
    proto = importlib.import_module(
        f"kzgbench.protocols.{config['protocol']}")
    plain = importlib.import_module(f"kzgbench.plain.{config['protocol']}")
    curve = CURVES[config["curve"]]
    on_card = device.type == "cuda"
    notes = []
    torch.set_num_threads(1)
    t_port = time.perf_counter()
    if on_card:
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)

    spans = Spans()
    tau = tau_from_seed(seed, curve.r)
    t_cell = time.perf_counter()
    cell = proto.Cell(config, traffic, seed, tau, device, spans)
    t_warm = time.perf_counter()
    slots = traffic["pool_batches"]
    for b in range(traffic["warmup_batches"]):
        cell.run_batch(b % slots)
    if on_card:
        torch.cuda.synchronize(device)
    before = ", ".join(f"{s:.3f} s {what}"
                       for what, s in (marks or {}).items())
    notes.append(f"set-up: {t_run - t0:.3f} s to the harness ({before}), "
                 f"{t_port - t_run:.3f} s the port's imports, "
                 f"{t_cell - t_port:.3f} s the first allocation and tau, "
                 f"{t_warm - t_cell:.3f} s the cell (SRS, contexts, pool), "
                 f"{time.perf_counter() - t_warm:.3f} s warm-up")
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if on_card:
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        spans.recording = True
        with spans("warmup.batch"):
            cell.run_batch(0)
    if on_card:
        torch.cuda.synchronize(device)
    undo = plant(cell) if plant is not None else None
    from kzg_snark_tpu_torch.utils import build
    build.reset_launches()
    spans.reset()

    # The set-up's objects out of the collector's way: no full collection
    # over them inside the window.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    traced_batches = traffic["trace_batches"] if traced else 0
    outputs, batches, failed_polys, errors, window_s = _window(
        cell, spans, slots, seconds, prof, traced_batches)
    gc.unfreeze()
    if undo is not None:
        undo()
    launches = build.launch_counts()
    host_spans = dict(spans.totals)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    # The card's peaks feed only the traced rooflines and the line's device
    # fields: read after the window, outside the set-up.
    rates = None
    if on_card:
        from .roofline import device_rates
        rates = device_rates(torch)
        notes.append(f"card: {torch.cuda.get_device_name(device)}, "
                     f"{rates['sms']} SMs, top SM clock "
                     f"{rates['sm_clock_mhz']} MHz ({rates['clock_from']}), "
                     f"power limit {rates['power_limit']}")
    if errors:
        notes.append(f"{len(errors)} batches raised: {errors[0]}")

    summary = None
    if prof is not None:
        summary = _export_trace(prof, spans, workload, host_spans, batches)
        del prof
        if summary:
            notes.append(
                f"trace: {summary['batches']} batches, "
                f"{summary['device_events']} device activities, "
                f"{summary['unattributed']} without a launch on the host")

    # The reference: the inputs to the host, the program's state freed.
    words = [cell.pool_words(s) for s in range(slots)]
    msm_calls = cell.msm_calls()
    del cell
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = Reference(curve, config["n"], tau)
    used = sorted({slot for slot, _ in outputs})
    expected = {s: plain.expected(ref, words[s]) for s in used}
    counts = compare(outputs, expected)
    notes.append(f"reference: {len(used)} pool batches in "
                 f"{time.perf_counter() - t_ref:.1f} s; compared "
                 + ", ".join(f"{counts[k][0]} {k}" for k in ANSWERS))

    polys = sum(k for _, _, k in batches) - failed_polys
    record = SimpleNamespace(
        workload=workload, config=config, traffic=traffic, seed=seed,
        setup_s=setup_s, window_s=window_s, batches=batches, polys=polys,
        traced_batches=traced_batches,
        launches=launches, host_span_s=host_spans, trace=summary,
        rates=rates, msm_calls=msm_calls, curve=curve,
        base_limbs=12 if curve.p.bit_length() > 256 else 8)
    metrics = read_metrics(record, cell_metrics(workload, traced, bench))

    checks = {f"{kind}_wrong": {"value": counts[kind][1], "limit": 0}
              for kind in ANSWERS}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) \
        and failed_polys == 0 and len(batches) > 0
    line = {"correct": correct,
            "attempted": sum(k for _, _, k in batches),
            "failed": failed_polys,
            "metrics": metrics,
            "device": {"platform": "gpu" if on_card else device.type,
                       "kind": torch.cuda.get_device_name(device)
                       if on_card else device.type,
                       "count": cell_entry["chips"],
                       "memory_peak_bytes": int(memory_peak)}}
    if rates:
        line["device"].update(sms=rates["sms"],
                              sm_clock_mhz=rates["sm_clock_mhz"],
                              power_limit=rates["power_limit"])
    if traced and summary:
        line["device"]["busy_s"] = summary["busy_us"] / 1e6
        line["device"]["window_s"] = summary["window_us"] / 1e6
        line["breakdown"] = trace_mod.breakdown(summary)
    batch_ms = [1e3 * (b2 - b1) for b1, b2, _ in batches]
    if traced and len(batch_ms) > traced_batches:
        on, off = batch_ms[:traced_batches], batch_ms[traced_batches:]
        notes.append(f"batch ms mean: {statistics.fmean(on):.3f} traced, "
                     f"{statistics.fmean(off):.3f} after the profiler "
                     f"stopped")
    notes.append(f"window {window_s:.3f} s, {len(batches)} batches, "
                 f"{polys} polynomials; batch ms median "
                 f"{statistics.median(batch_ms):.3f}, max "
                 f"{max(batch_ms):.3f}; set-up {setup_s:.3f} s")
    return {"line": line, "checks": checks, "notes": notes}
