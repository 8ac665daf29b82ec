"""Where the time of the PyTorch port's main path goes on the GPU.

Profiles, with torch.profiler, the two UNet calls the directinversion+p2p
edit is made of: the inversion call (1 row, no control) and the fused scan
call (3 rows under P2P refine + LocalBlend + reweight), at SD1.4 full width
in bf16 with random weights. For each it prints one JSON line: wall time
per call (timed without the profiler), the sum of device kernel time per
call (from the profiler), the device's idle share (1 - their ratio),
kernel launches per call, the flash kernel's share, and the ten kernels
that take the most device time.

    python3 scripts/profile_torch_unet.py [--calls N]

Needs one CUDA device; builds the port's kernels first.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile_calls(fn, calls: int) -> dict:
    """Wall time of ``calls`` calls without the profiler (it slows the host
    several-fold), then device kernel time of as many calls under it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    flash_us = sum(v for k, v in by_name.items() if "flash_fwd_kernel" in k)
    return {
        "wall_ms_per_call": wall * 1e3 / calls,
        "device_ms_per_call": busy_us / 1e3 / calls,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernels_per_call": len(kernels) / calls,
        "flash_share_of_device": flash_us / busy_us if busy_us else 0.0,
        "top": [{"kernel": k[:90], "ms_per_call": v / 1e3 / calls}
                for k, v in by_name.most_common(10)],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_unet: no CUDA device", file=sys.stderr)
        return 1
    from pnpinversion_tpu_torch.configs import SD14
    from pnpinversion_tpu_torch.control.p2p import P2PControl
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    pipe = SDPipeline.create(SD14, seed=0)
    editor = P2PEditor(pipe)
    src = "a round cake with orange frosting on a wooden plate"
    tar = "a square cake with orange frosting on a wooden plate"
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        cond, uncond = editor.embeds([src, tar])
        spec, tensors = editor.make_control([src, tar], blend_word=(("cake",), ("cake",)),
                                            eq_params={"words": ("square",), "values": (2.0,)})
        control = P2PControl(dataclasses.replace(spec, uncond_rows=1))
        x1 = torch.randn((1, 64, 64, 4), generator=gen, device="cuda").to(pipe.dtype)
        x3 = torch.randn((3, 64, 64, 4), generator=gen, device="cuda").to(pipe.dtype)
        ctx3 = torch.cat([uncond[1:], cond])
        state = control.init_state(2, heads=8, device="cuda")
        rows = {
            "invert_call_b1": lambda: pipe.unet(x1, 481, cond[:1]),
            # step 5: inside the self-replace window and past LocalBlend's start
            "scan_call_b3_p2p": lambda: pipe.unet(x3, 481, ctx3, control, tensors, state, 5),
        }
        for name, fn in rows.items():
            print(name, json.dumps(profile_calls(fn, args.calls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
