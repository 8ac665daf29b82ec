"""The bf16 flash forward (csrc/flash_attention_fwd.cu) against its roofline:
the cell's frozen attention work (work/<cell>.json: B·H, Sq, Sk, d, launches)
at 989 TFLOP/s and 3.35 TB/s (bf16 Q, K, V, O once), over the kernel's device
time in the profiled batch, %."""
from perfbench import readers

KERNELS = r"flash_fwd_wgmma_kernel"


def read(run):
    return readers.roofline(run, KERNELS, readers.BF16_PEAK, 2)


def note(run):
    return readers.launches_note(run, KERNELS, "flash_fwd_roofline.sweep")
