"""Device time of PyTorch's elementwise kernels (by name, the frozen
``kernel_category``) over busy time in the profiled batch, %."""
from perfbench import readers


def read(run):
    return readers.share(run, "elementwise")
