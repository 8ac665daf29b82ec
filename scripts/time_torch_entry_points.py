"""Seconds of the port's entry points on local weights, at full length, on
the card: ``chip_smoke.entry_points_phase`` at 50 DDIM steps (the smoke runs
it at ``ENTRY_STEPS``), after a warm-up of the same phase at 2 steps, so the
bf16 ×4 sweep is not the process's first batch.

    python3 scripts/time_torch_entry_points.py [--steps 50] [--out build/entry.json]

Prints the card's name and power limit, then the phase's JSON: the f16
SD1.4 checkpoint's size, the load's seconds and GB/s for the f32 runner's
and the bf16 sweep's pipelines, ``run_editing_p2p``'s seconds per image
(f32), ``run_sweep``'s seconds per image at ×4 (bf16, without the load),
each path's kernel launches and its checks (see the phase's docstring).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from pnpinversion_tpu_torch.ops import build
    from pnpinversion_tpu_torch.ops.flash_attention import (BWD_KERNEL, F32_BWD_KERNEL,
                                                            F32_FWD_KERNEL, KERNEL)

    if not torch.cuda.is_available():
        raise SystemExit("time_torch_entry_points: no CUDA device")
    print(chip_smoke.card_line(), flush=True)
    build.build([KERNEL, BWD_KERNEL, F32_BWD_KERNEL, F32_FWD_KERNEL])
    chip_smoke.entry_points_phase(steps=2)  # warm-up: kernels, cuDNN plans, allocator
    out = {"card": chip_smoke.card_line(), **chip_smoke.entry_points_phase(steps=args.steps)}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
