"""msm_ms (MSM): device ms a traced batch of every kernel and torch op
launched in the ``commit.*`` spans: scalar conversion, schedule,
accumulate, reduce and the affine conversion of the results."""

from . import span_device_ms


def read(record):
    return span_device_ms(record, "commit.")
