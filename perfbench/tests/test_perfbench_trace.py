"""The frozen device-time arithmetic equals the program's utils/mfu.py on a
synthetic trace (while the program still has it)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import device_trace  # noqa: E402

SPANS = [("void flash_fwd_kernel<128, 3>", 0.0, 40.0),
         ("ampere_bf16_s16816gemm_bf16_128x64", 30.0, 90.0),
         ("void at::native::vectorized_elementwise_kernel<4, add>", 95.0, 99.0),
         ("void at::native::reduce_kernel<512, 1>", 120.0, 130.0),
         ("Memcpy HtoD (Pageable -> Device)", 130.0, 400.0),
         ("sm80_xmma_fprop_implicit_gemm_f32f32_tf32f32", 200.0, 260.0),
         ("volta_sgemm_128x64_nn", 250.0, 270.0),
         ("softmax_warp_forward", 300.0, 301.5),
         ("void group_norm_moments", 310.0, 311.0),
         ("some_custom_thing", 320.0, 321.0)]


def test_frozen_arithmetic_equals_the_program():
    mfu = pytest.importorskip("pnpinversion_tpu_torch.utils.mfu")
    ours, theirs = device_trace.device_activity(SPANS), mfu.device_activity(SPANS)
    for k in ("busy_us", "tensor_core_us", "kernels", "by_name", "by_category"):
        assert ours[k] == theirs[k], k
    for name, _, _ in SPANS:
        assert device_trace.kernel_category(name) == mfu.kernel_category(name)
    assert device_trace.union_us([(0, 2), (1, 3), (5, 6)]) == mfu._union_us([(0, 2), (1, 3), (5, 6)])


def test_idle_gaps_named_by_the_open_host_span():
    intervals = [(10.0, 20.0), (50.0, 60.0)]
    host = [("perfbench.profiled_batch", 0.0, 100.0), ("aten::copy_", 20.0, 45.0),
            ("perfbench.unet_call", 55.0, 99.0)]
    gaps = device_trace.idle_gaps(intervals, host, (0.0, 100.0))
    assert gaps[0] == ("perfbench.unet_call", pytest.approx(40e-6))
    assert gaps[1] == ("aten::copy_", pytest.approx(30e-6))
    assert gaps[2] == ("perfbench.profiled_batch", pytest.approx(10e-6))
