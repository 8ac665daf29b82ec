"""Seconds of the PyTorch port's weight-only int8 UNet (``--quant w8``,
``ops/quant.py``) against the float one on one NVIDIA GPU, in bf16 at SD1.4
width (random weights from seed 0, 512^2, the smoke's cake prompts):

- ``directinversion+p2p`` through ``P2PEditor`` on one image and through
  ``BatchedDirectInversionP2P`` (what ``runners.run_sweep`` runs) on 4, at
  ``--steps`` (50) DDIM steps, float and w8 in turns (float, w8, w8, float,
  each after a 2-step warm-up of both), each to a synchronize;
- one UNet call of the scan's 3 rows, float and w8, under torch.profiler:
  wall and device ms per call, the device's idle share, kernels per call
  and the kernels that take the most device time (the int8 weights' casts
  and the scale multiplies among them);
- the UNet's weight bytes both ways.

Prints the card's name and power limit, one JSON line a measurement, then
all of them as one JSON object (also written to ``--out``).

    python3 scripts/time_torch_w8.py [--steps 50] [--calls 5] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_w8: no CUDA device", file=sys.stderr)
        return 1
    from profile_torch_unet import profile_calls

    from pnpinversion_tpu_torch.configs import SD14
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor
    from pnpinversion_tpu_torch.ops import build
    from pnpinversion_tpu_torch.ops.flash_attention import KERNEL
    from pnpinversion_tpu_torch.parallel.sweep import BatchedDirectInversionP2P
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    card = chip_smoke.card_line()
    print(card, flush=True)
    build.build([KERNEL])
    pipes = {mode: SDPipeline.create(SD14, seed=0, num_ddim_steps=args.steps, quantize=mode)
             for mode in ("none", "w8")}
    out = {"card": card, "steps": args.steps,
           "unet_weight_bytes": {m: chip_smoke._module_bytes(p.unet) for m, p in pipes.items()}}
    image = chip_smoke._random_images(99)
    img1, imgs = image(), np.stack([image() for _ in range(chip_smoke.BATCH)])
    runs = {}
    for mode, pipe in pipes.items():
        editor, sweep = P2PEditor(pipe), BatchedDirectInversionP2P(pipe)
        batch = chip_smoke._cake_batch(pipe, [(chip_smoke.SRC, chip_smoke.TAR)]
                                       * chip_smoke.BATCH)
        runs[mode] = {
            "x1": lambda e=editor: e("directinversion+p2p", img1, chip_smoke.SRC,
                                     chip_smoke.TAR, **chip_smoke.EDIT_KW),
            f"x{chip_smoke.BATCH}": lambda s=sweep, b=batch: s.edit_batch(
                b[0], imgs, b[1], b[2], 7.5, b[3])}
        warm = chip_smoke._pipe_at(pipe, 2)
        P2PEditor(warm)("directinversion+p2p", img1, chip_smoke.SRC, chip_smoke.TAR,
                        **chip_smoke.EDIT_KW)
        wb = chip_smoke._cake_batch(warm, [(chip_smoke.SRC, chip_smoke.TAR)] * chip_smoke.BATCH)
        BatchedDirectInversionP2P(warm).edit_batch(wb[0], imgs, wb[1], wb[2], 7.5, wb[3])
    seconds = {m: {k: [] for k in runs[m]} for m in runs}
    for mode in ("none", "w8", "w8", "none"):
        for key, fn in runs[mode].items():
            _, t = chip_smoke._sync_time(fn)
            seconds[mode][key].append(t)
    for mode in runs:
        for key, ts in seconds[mode].items():
            n = 1 if key == "x1" else chip_smoke.BATCH
            row = {"mode": mode, "path": key, "s_per_image": [t / n for t in ts]}
            print("edit", json.dumps(row), flush=True)
    out["edit_s_per_image"] = {m: {k: [t / (1 if k == "x1" else chip_smoke.BATCH) for t in ts]
                                   for k, ts in seconds[m].items()} for m in seconds}
    out["w8_over_float"] = {k: float(np.mean(out["edit_s_per_image"]["w8"][k])
                                     / np.mean(out["edit_s_per_image"]["none"][k]))
                            for k in seconds["none"]}
    out["unet_call_b3"] = {}
    for mode, pipe in pipes.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((3, 64, 64, 4), generator=g, device="cuda").to(pipe.dtype)
        ctx = torch.randn((3, 77, 768), generator=g, device="cuda").to(pipe.dtype)
        with torch.inference_mode():
            row = profile_calls(lambda: pipe.unet(x, 481, ctx), args.calls)
        out["unet_call_b3"][mode] = row
        print("unet_call_b3", mode, json.dumps(row), flush=True)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
