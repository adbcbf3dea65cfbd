"""syncs_per_batch (harness / host protocol): the port's host waits on the
card over every batch of the window (``utils/build.sync_counts``: blocking
copies, values read back, synchronizes, each counted where the port
waits; the harness zeroes the counts before the window), a batch.  Read
when the run's metrics are read, after the window: nothing calls the port
in between.  None on a program without the counter."""


def read(record):
    from kzg_snark_tpu_torch.utils import build
    counts = getattr(build, "sync_counts", None)
    if counts is None or not record.batches:
        return None
    return sum(counts().values()) / len(record.batches)
