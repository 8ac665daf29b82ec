"""Device idle inside the program's UNet calls, %: of the time the main
thread spends inside ``pnpi.unet.call`` spans over the profiled batch, the
share with no kernel running (the device waiting on the call's launches and
on its host waits)."""
from perfbench import program_spans


def read(run):
    return program_spans.unet_idle_share(run)
