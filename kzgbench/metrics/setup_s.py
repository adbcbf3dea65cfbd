"""setup_s: process start to the first timed batch (host clock): imports,
the kernels' library, the SRS, the contexts, the pool and the warm-up."""


def read(record):
    return record.setup_s
