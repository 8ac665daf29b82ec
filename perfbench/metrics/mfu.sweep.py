"""The cell's frozen model FLOPs per image times the images over the window's
seconds, over the dense bf16 peak (989 TFLOP/s), %."""
from perfbench import readers


def read(run):
    return readers.mfu(run, readers.BF16_PEAK)
