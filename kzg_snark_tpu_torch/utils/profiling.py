"""Phase timing, spans and device traces.

The port's counterpart of the JAX package's ``utils/profiling.py``:
``PhaseTimer`` accumulates wall time per named phase and ``device_trace``
writes a ``torch.profiler`` Chrome trace of the card's kernels.  Work on
the card is asynchronous, so both wait for it: a CUDA tensor synchronizes
its device, and anything with ``block_until_ready`` is waited on as the
JAX utilities do.

``span(name)`` marks a step of the port (``msm.schedule``, ``kzg.open``,
``plonk.round1_wires``, ...) for whoever profiles it: while a torch
profiler records it is a ``record_function`` range, so the step, its
nesting and the device work launched inside it land in the profiler's
trace on one clock; otherwise it is a shared no-op that neither reads a
clock nor waits for the device.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


# The shared span of a run that no profiler records.
_NO_SPAN = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context over one step named ``<layer>.<step>``: a
    ``record_function`` range while a torch profiler records, else the
    shared no-op context (no range object, no clock read).  It keeps no
    totals: the trace holds each range's start, end and parent."""
    if _recording():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def block(result) -> None:
    """Wait for the device work behind ``result``: a CUDA tensor
    synchronizes its device; an object with ``block_until_ready`` is waited
    on; anything else (a CPU tensor, None, a host value) is already done."""
    if torch.is_tensor(result):
        if result.device.type == "cuda":
            torch.cuda.synchronize(result.device)
    elif hasattr(result, "block_until_ready"):
        result.block_until_ready()


class PhaseTimer:
    """Accumulates wall time per named phase; the device work behind
    ``block_on`` is waited for before a phase closes."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            block(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict:
        return {name: {"total_s": round(t, 4),
                       "count": self.counts[name],
                       "mean_s": round(t / self.counts[name], 4)}
                for name, t in sorted(self.totals.items())}

    def dump(self) -> str:
        return json.dumps(self.report(), indent=2)


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler over the block, the card's activities included when
    there is one; writes ``logdir/trace.json`` (Chrome trace format, for
    Perfetto or chrome://tracing) and yields the profile."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

