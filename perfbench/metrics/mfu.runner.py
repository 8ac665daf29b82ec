"""The cell's frozen model FLOPs per image times the images over the window's
seconds, over the dense TF32 peak (495 TFLOP/s): no f32-input product runs
faster on the card, %."""
from perfbench import readers


def read(run):
    return readers.mfu(run, readers.TF32_PEAK)
