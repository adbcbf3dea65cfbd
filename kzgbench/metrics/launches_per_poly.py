"""launches_per_poly (harness / host protocol): the port's kernel launches
over the window (``utils/build.launch_counts``, every kernel wrapper counts
its launch), a polynomial done.  Torch ops are not counted."""


def read(record):
    total = sum(record.launches.values())
    return total / record.polys if total and record.polys else None
