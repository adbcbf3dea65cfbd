"""Reading a torch.profiler Chrome trace into what the per-layer metrics need.

The harness opens a ``torch.profiler.record_function`` span around each call
into a layer (``harness.Spans``); a device activity (kernel, copy, set)
belongs to every span that was open on the host when its launch was made,
matched by the CUPTI correlation id between the activity and its runtime or
driver launch call.  Device busy time is the union of the activities'
intervals inside the traced window, which runs from the first timed batch's
start to the last traced batch's end; the idle gaps are labelled by the
innermost span open on the host in their middle.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "user_annotation"
BATCH_SPAN = "window.batch"


def short_name(name: str) -> str:
    """A kernel's name without 'void ', an anonymous namespace and its
    argument list."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                  "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return name[:i][:120]
    return name[:120]


class _Spans:
    """Host spans sorted by start, for 'which spans hold time t'."""

    def __init__(self, spans: list):
        # By start, a parent before the children that start with it, so a
        # walk back from t meets the inner spans first.
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]

    def holding(self, t: float) -> list:
        """Names of the spans open at t, innermost first."""
        out = []
        i = bisect.bisect_right(self.starts, t) - 1
        steps = 0
        while i >= 0 and steps < 64:
            a, b, name = self.spans[i]
            if a <= t <= b:
                out.append((b - a, name))
                if name == BATCH_SPAN:
                    break
            i -= 1
            steps += 1
        return [name for _, name in sorted(out)]


def summarize(path: str) -> dict:
    """The traced window of a Chrome trace -> {"batches", "window_us",
    "busy_us", "span_device_us", "kernel_us", "idle_by_span_us",
    "device_events", "unattributed"}."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans, launches, device = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == SPAN_CAT:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                          e["name"]))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
        elif cat in DEVICE_CATS:
            device.append(e)
    batches = [s for s in spans if s[2] == BATCH_SPAN]
    if not batches:
        return {}
    lo = min(s[0] for s in batches)
    hi = max(s[1] for s in batches)
    host = _Spans(spans)

    span_us: dict = defaultdict(float)
    kernel_us: dict = defaultdict(float)
    intervals, unattributed = [], 0
    for e in device:
        a = float(e["ts"])
        if not lo <= a <= hi:
            continue
        dur = float(e.get("dur", 0.0))
        intervals.append((a, a + dur))
        name = short_name(e.get("name", "?"))
        kernel_us[name] += dur
        t = launches.get((e.get("args") or {}).get("correlation"))
        if t is None:
            unattributed += 1
            continue
        for s in set(host.holding(t)):
            span_us[s] += dur

    intervals.sort()
    busy, idle = 0.0, defaultdict(float)
    end = lo
    for a, b in intervals + [(hi, hi)]:
        if a > end:
            gap = a - end
            held = host.holding(end + gap / 2)
            idle[held[0] if held else "(no span)"] += gap
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"batches": len(batches), "window_us": hi - lo, "busy_us": busy,
            "span_device_us": dict(span_us), "kernel_us": dict(kernel_us),
            "idle_by_span_us": dict(idle),
            "device_events": len(intervals), "unattributed": unattributed}


def breakdown(summary: dict) -> dict:
    """The line's optional ``breakdown``: the ten device ops that took the
    most time and the ten host spans with the most idle device time under
    them, in seconds over the traced window."""
    ops = sorted(summary["kernel_us"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["idle_by_span_us"].items(),
                  key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name, us / 1e6] for name, us in ops],
            "idle_gaps": [[name, us / 1e6] for name, us in gaps]}
