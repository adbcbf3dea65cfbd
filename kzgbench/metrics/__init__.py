"""One reader a metric: ``metrics/<name>.py`` (dots and dashes of the name
as underscores) defines ``read(record)``, which returns the metric's value
or None where the run has nothing to read for it (the harness then leaves
the metric out of the line).  The helpers below read the trace summary of
``kzgbench/trace.py``."""

from __future__ import annotations

import re


def span_device_ms(record, prefix: str):
    """Device ms a traced batch of the activities launched in the spans
    whose names start with ``prefix``; None without a trace."""
    t = record.trace
    if not t or not t["batches"]:
        return None
    us = sum(v for k, v in t["span_device_us"].items() if k.startswith(prefix))
    return us / 1e3 / t["batches"] if us > 0 else None


def kernel_s_per_batch(record, pattern: str):
    """Device seconds a traced batch of the kernels whose short names match
    ``pattern``; None without a trace or without such a kernel."""
    t = record.trace
    if not t or not t["batches"]:
        return None
    rx = re.compile(pattern)
    us = sum(v for k, v in t["kernel_us"].items() if rx.search(k))
    return us / 1e6 / t["batches"] if us > 0 else None


def roofline_pct(record, pattern: str, work) -> float | None:
    """Share (%) of the kernels matching ``pattern`` of their bound: the
    frozen work of the batch's MSMs (``work(n, k, limbs, bits)`` ->
    (bytes, products), kzgbench/roofline.py) over the card's peaks, against
    their traced device time a batch."""
    from ..roofline import bound_s
    t = kernel_s_per_batch(record, pattern)
    if t is None or not record.rates:
        return None
    nbytes = products = 0.0
    for n, k in record.msm_calls:
        b, p = work(n, k, record.base_limbs, record.curve.r.bit_length())
        nbytes += b
        products += p
    return 100.0 * bound_s(record.rates, nbytes, products)[0] / t
