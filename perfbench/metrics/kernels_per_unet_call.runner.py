"""Device kernels in the profiled batch over the UNet calls in it."""
from perfbench import readers


def read(run):
    return readers.kernels_per_unet_call(run)
