"""batch_ms.p95: the 95th percentile of every batch's time in the window,
from its submission to all its answers on the host (host clock)."""

import statistics


def read(record):
    ms = [1e3 * (b - a) for a, b, _ in record.batches]
    if len(ms) < 2:
        return ms[0] if ms else None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
