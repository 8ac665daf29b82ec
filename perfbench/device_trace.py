"""Device time from a torch.profiler trace: a frozen copy of the port's
``utils/mfu.py`` arithmetic (``kernel_category``, the busy time as the union
of kernel intervals, ``kernel_spans`` from kineto's raw events,
``device_activity``), kept with the benchmark so that a change to the program
cannot change how it is measured; plus the idle gaps, each named by what the
host was doing when it began.
"""
from __future__ import annotations

import bisect
import re

TENSOR_CORE_KERNEL = re.compile(
    r"gemm|xmma|nvjet|cutlass|wgmma|tensorop|s16816|s1688|fprop|dgrad|wgrad"
    r"|flash_(fwd|bwd)(_f32)?_kernel|flash_bwd_(dq|dkv)_f32_kernel",
    re.IGNORECASE)
CUDA_CORE_KERNEL = re.compile(r"ffma|sgemm|gemv", re.IGNORECASE)
KERNEL_CATEGORIES = (("cuda_core_gemm", CUDA_CORE_KERNEL),
                     ("softmax", re.compile(r"softmax", re.IGNORECASE)),
                     ("elementwise", re.compile(r"elementwise", re.IGNORECASE)),
                     ("reduction_or_norm", re.compile(r"reduce|moments|norm", re.IGNORECASE)))


def is_tensor_core(name: str) -> bool:
    return bool(TENSOR_CORE_KERNEL.search(name)) and not CUDA_CORE_KERNEL.search(name)


def kernel_category(name: str) -> str:
    if is_tensor_core(name):
        return "tensor_core"
    return next((cat for cat, pattern in KERNEL_CATEGORIES if pattern.search(name)), "other")


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def trace_spans(prof):
    """(device spans, host spans) of a finished profile, from kineto's raw
    events: each (name, start µs, end µs); the device's are its kernels,
    copies and memsets (user annotations left out)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.name(), e.start_ns() * 1e-3, (e.start_ns() + e.duration_ns()) * 1e-3)
        if e.device_type() != cuda:
            host.append(span)
        elif not e.is_user_annotation():  # a host span's mirror on the device's timeline
            dev.append(span)
    return dev, host


def device_activity(spans) -> dict:
    """busy_us (union of kernel intervals, copies and memsets left out),
    tensor_core_us, kernels, by_name {name: [us, launches, category]},
    by_category {category: summed us}, intervals (the kernels' (start, end))."""
    busy, tc, by_name = [], [], {}
    for name, start, end in spans:
        row = by_name.get(name)
        if row is None:
            if name.startswith(("Memcpy", "Memset")):
                continue
            row = by_name[name] = [0.0, 0, kernel_category(name)]
        busy.append((start, end))
        if row[2] == "tensor_core":
            tc.append((start, end))
        row[0] += end - start
        row[1] += 1
    by_category = {}
    for us, _, cat in by_name.values():
        by_category[cat] = by_category.get(cat, 0.0) + us
    return {"busy_us": union_us(busy), "tensor_core_us": union_us(tc), "kernels": len(busy),
            "by_name": by_name, "by_category": by_category, "intervals": busy}


def idle_gaps(intervals, host_spans, window, top: int = 10):
    """The ``top`` longest stretches in ``window`` (start, end µs) with no
    kernel running, each named by the innermost host span (an operator, or
    the benchmark's own ``perfbench.*`` spans) open when it began:
    [(name, seconds)]."""
    lo, hi = window
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = sorted((s for s in host_spans if s[2] > s[1]), key=lambda s: s[1])
    starts = [s[1] for s in host]
    out = []
    for a, b in gaps:
        # the span that began last before the gap and is still open: the innermost
        i = bisect.bisect_right(starts, a)
        name = next((host[j][0] for j in range(i - 1, max(-1, i - 4000), -1)
                     if host[j][2] >= a), "host: no span open")
        out.append((name[:120], (b - a) * 1e-6))
    return out
