"""Device-busy milliseconds per image: the union of the profiled batch's
kernel intervals (copies and memsets left out) over its images. The device's
share of the work, steady where the host paces the rate."""
from perfbench import readers


def read(run):
    act = readers.activity(run)
    if act is None or not run["profile"]["images"]:
        return None
    return act["busy_us"] * 1e-3 / run["profile"]["images"]
