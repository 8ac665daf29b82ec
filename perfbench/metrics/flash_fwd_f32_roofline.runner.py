"""The f32 flash forward (csrc/flash_attention_fwd_f32.cu: split pass and main
kernel) against its roofline: the cell's frozen attention work at 495 TFLOP/s
(TF32, the fastest f32-input product) and 3.35 TB/s (f32 Q, K, V, O once),
over both kernels' device time in the profiled image, %."""
from perfbench import readers

KERNELS = r"flash_fwd_f32_(split_)?kernel"


def read(run):
    return readers.roofline(run, KERNELS, readers.TF32_PEAK, 4)


def note(run):
    return readers.launches_note(run, KERNELS, "flash_fwd_f32_roofline.runner")
