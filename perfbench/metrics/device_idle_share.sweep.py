"""1 - busy / wall, %: busy the union of the profiled batch's kernel intervals
(copies and memsets left out), wall the untraced window's time per batch."""
from perfbench import readers


def read(run):
    return readers.device_idle_share(run)
