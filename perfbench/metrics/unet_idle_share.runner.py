"""Device idle inside the program's UNet calls, %: of the time the main
thread spends inside ``pnpi.unet.call`` spans over the profiled image, the
share with no kernel running. The note gives the split's coverage, as
``between_unet_idle_ms_per_image.sweep``'s does for the sweeps."""
from perfbench import program_spans


def read(run):
    return program_spans.unet_idle_share(run)


def note(run):
    return program_spans.idle_note(run, "unet_idle_share.runner")
