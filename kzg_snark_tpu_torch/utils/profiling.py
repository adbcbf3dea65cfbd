"""Phase timing and device traces.

The port's counterpart of the JAX package's ``utils/profiling.py``:
``PhaseTimer`` accumulates wall time per named phase, ``device_trace``
writes a ``torch.profiler`` Chrome trace of the card's kernels, and
``timed`` takes the best of a few calls.  Work on the card is asynchronous,
so each waits for it: a CUDA tensor synchronizes its device, and anything
with ``block_until_ready`` is waited on as the JAX utilities do.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


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


def timed(fn, *args, reps: int = 3, **kwargs):
    """(best seconds, result) over ``reps`` calls, each waited for."""
    result = None
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        block(result)
        best = min(best, time.perf_counter() - t0)
    return best, result
