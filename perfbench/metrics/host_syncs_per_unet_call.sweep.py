"""Copies the host waits for (the program's ``pnpi.sync.*`` counters:
timesteps, images, control tensors, token ids, masks, panels) over its UNet
calls (``pnpi.unet.calls``), in the profiled batch."""
from perfbench import program_spans


def read(run):
    return program_spans.host_syncs_per_unet_call(run)


def note(run):
    return program_spans.syncs_note(run, "host_syncs_per_unet_call.sweep")
