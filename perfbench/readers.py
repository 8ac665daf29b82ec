"""Arithmetic the per-layer metric readers share. Each reader
(``metrics/<metric>.py``) takes the run's record and returns its number, or
None where the run holds nothing to read (no trace, no device time, no call):
never 0 for a share of a peak or a roofline.
"""
from __future__ import annotations

import re

BF16_PEAK = 989e12  # dense bf16 FLOP/s, H100 SXM at 700 W (NVIDIA's data sheet)
TF32_PEAK = 495e12  # dense TF32 FLOP/s: the fastest any f32-input product runs on the card
HBM_BYTES_S = 3.35e12


def activity(run):
    prof = run.get("profile")
    if not prof or prof["activity"]["busy_us"] <= 0:
        return None
    return prof["activity"]


def kernels_per_unet_call(run):
    act = activity(run)
    if act is None or not run["profile"]["calls"]:
        return None
    return act["kernels"] / run["profile"]["calls"]


def device_idle_share(run):
    """100 (1 - busy / wall): busy of the profiled batch, its wall the untraced
    window's per batch (the profiler's own host cost left out)."""
    act = activity(run)
    if act is None or not run["images"]:
        return None
    wall = run["window_s"] * run["profile"]["images"] / run["images"]
    return 100.0 * (1.0 - act["busy_us"] * 1e-6 / wall)


def mfu(run, peak: float):
    work = run["work"].get("flops_per_image")
    if not work or not run["images"]:
        return None
    return 100.0 * work * run["images"] / run["window_s"] / peak


def _flash(run, pattern: str):
    act = activity(run)
    work = run["work"].get("flash")
    if act is None or not work:
        return None
    rx = re.compile(pattern)
    rows = [r for n, r in act["by_name"].items() if rx.search(n)]
    scale = run["profile"]["images"] / run["work"]["chunk_images"]
    return rows, work, scale


def roofline(run, pattern: str, peak: float, elem_bytes: int):
    """100 x the least time of the listed attention work (the larger of
    4·B·H·Sq·Sk·d over ``peak`` and its bytes, Q, K, V read once and O written
    once, over HBM's) over the device time of the kernels named ``pattern``."""
    found = _flash(run, pattern)
    if found is None:
        return None
    rows, work, scale = found
    us = sum(r[0] for r in rows)
    if us <= 0:
        return None
    bound = sum(k * max(4.0 * bh * sq * sk * d / peak,
                        elem_bytes * bh * d * (2 * sq + 2 * sk) / HBM_BYTES_S)
                for bh, sq, sk, d, k in work)
    return 100.0 * bound * scale / (us * 1e-6)


def launches_note(run, pattern: str, name: str) -> str:
    found = _flash(run, pattern)
    if found is None:
        return f"{name}: nothing to read"
    rows, work, scale = found
    return (f"{name}: {sum(r[1] for r in rows)} launches of /{pattern}/ in the trace, "
            f"{sum(w[-1] for w in work) * scale:g} in the work list")


def share(run, category: str):
    act = activity(run)
    if act is None:
        return None
    return 100.0 * act["by_category"].get(category, 0.0) / act["busy_us"]
