"""msm_schedule_ms (MSM): device ms a traced batch of the activities
launched in the port's ``msm.schedule`` spans (``FusedMsm.schedule``: the
signed digits and the bucket schedule's torch ops: the nonzero pick, the
sort, the histogram, the scans and gathers).  None on a program without
those spans."""

from . import span_device_ms


def read(record):
    return span_device_ms(record, "msm.schedule")
