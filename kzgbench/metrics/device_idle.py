"""device_idle (device): the share (%) of a batch's wall time in which no
activity ran on the card.  The busy time a batch is the union of the
kernels', copies' and sets' intervals over the traced batches; the wall
time a batch is the mean of the same run's batches after the profiler
stopped, so that the profiler's own cost on the host is not counted as
idle device time."""


def read(record):
    t = record.trace
    rest = record.batches[record.traced_batches:]
    if not t or not t["batches"] or not t["device_events"] or not rest:
        return None
    wall_us = 1e6 * sum(b - a for a, b, _ in rest) / len(rest)
    return 100.0 * (1.0 - t["busy_us"] / t["batches"] / wall_us)
