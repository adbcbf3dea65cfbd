"""msm_idle_ms (MSM): device idle ms a traced batch whose innermost host
span is one of the port's ``msm.*`` spans (``msm.table``,
``msm.schedule``, ``msm.accumulate``, ``msm.reduce``): the card waiting
while the host works inside the MSM.  None on a program without those
spans."""


def read(record):
    t = record.trace
    if not t or not t["batches"]:
        return None
    us = sum(v for k, v in t["idle_by_span_us"].items()
             if k.startswith("msm."))
    return us / 1e3 / t["batches"] if us > 0 else None
