"""Full-length seconds per edited image of the PyTorch port's last three
editing families on one NVIDIA GPU, at the reference's settings:

- ``ddim+pix2pix-zero`` and ``directinversion+pix2pix-zero`` (SD1.4, 50
  steps, the caption injected), and ``BatchedPix2PixZero`` on 4 images;
- ``stylediffusion+p2p`` (SD1.4, 50 steps, 100 inner steps, the CLIP
  ViT-B/16 image tokens);
- ``blended-latent-diffusion`` (SD2.1-base, 50 steps: 38 UNet calls) and
  ``BatchedBLD`` on 4 images.

Random weights from seed 0, bf16, 512^2. Each run follows a warm-up at 2
steps; each is timed on the host clock to a ``torch.cuda.synchronize()``,
with its peak device memory and its flash-kernel launches. Prints the card's
name and power limit first, then one JSON line per run, then all of them as
one JSON object (also written to ``--out`` when given).

    python scripts/time_torch_families.py [--only bld,p2z,sd] [--inner 100] [--out FILE]
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STEPS = 50
BATCH = 4
CAPTION = "a round cake with orange frosting on a wooden plate"


def _timed(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    from pnpinversion_tpu_torch.ops import flash_attention as fa

    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_main)
    before = [w.launches for w in wrappers]
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {"s": time.perf_counter() - t0,
                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "flash_fwd_launches": wrappers[0].launches - before[0],
                 "flash_bwd_main_launches": wrappers[1].launches - before[1]}


def _pipe_at(pipe, steps):
    from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule

    return dataclasses.replace(pipe, schedule=make_ddim_schedule(steps))


def _emit(rows, name, row):
    rows[name] = row
    print(name, json.dumps(row), flush=True)


def p2z_runs(pipe, imgs, prompts, rows):
    from pnpinversion_tpu_torch.editors import pix2pix_zero_editor as ped
    from pnpinversion_tpu_torch.parallel.sweep import BatchedPix2PixZero

    for method in ped.METHODS:
        ped.Pix2PixZeroEditor(_pipe_at(pipe, 2))(method, imgs[0], *prompts[0], caption=CAPTION)
        strip, row = _timed(lambda: ped.Pix2PixZeroEditor(pipe)(method, imgs[0], *prompts[0],
                                                                 caption=CAPTION))
        _emit(rows, method, {"steps": STEPS, **row, "edit_panel_std": float(strip[:, 1536:].std())})
    cond = torch.stack([pipe.encode_prompt([CAPTION]) for _ in prompts])
    dirs = torch.stack([ped.construct_direction(pipe, [s], [t]) for s, t in prompts])
    method = ped.METHODS[1]
    BatchedPix2PixZero(_pipe_at(pipe, 2)).edit_batch(method, imgs, cond, dirs)
    _, row = _timed(lambda: BatchedPix2PixZero(pipe).edit_batch(method, imgs, cond, dirs))
    _emit(rows, f"batched {method} x{BATCH}", {"steps": STEPS, **row,
                                                 "s_per_image": row["s"] / BATCH})


def sd_runs(pipe, imgs, prompts, rows, inner):
    from pnpinversion_tpu_torch.editors import stylediffusion_editor as sde
    from pnpinversion_tpu_torch.inversion.stylediffusion import inner_steps_schedule

    clip = sde.make_clip_vision(pipe.device)
    sde.StyleDiffusionEditor(_pipe_at(pipe, 2), clip)(sde.METHOD, imgs[0], *prompts[0],
                                                      num_inner_steps=1)
    seconds = {}
    train = sde.train_mappers

    def timed_train(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train(*a, **k)
        torch.cuda.synchronize()
        seconds["train_mappers_s"] = time.perf_counter() - t0
        return out

    sde.train_mappers = timed_train
    try:
        strip, row = _timed(lambda: sde.StyleDiffusionEditor(pipe, clip)(
            sde.METHOD, imgs[0], *prompts[0], num_inner_steps=inner))
    finally:
        sde.train_mappers = train
    k = row["flash_bwd_main_launches"] // 9  # nine differentiated sites an inner step
    _emit(rows, sde.METHOD, {"steps": STEPS, "num_inner_steps": inner, **row, **seconds,
                             "inner_steps_taken": k,
                             "inner_steps_most": int(inner_steps_schedule(STEPS, inner).sum()),
                             "training_s_per_inner_step": seconds["train_mappers_s"] / max(k, 1),
                             "edit_panel_std": float(strip[:, 1536:].std())})


def bld_runs(imgs, prompts, rows):
    from pnpinversion_tpu_torch.configs import SD21
    from pnpinversion_tpu_torch.editors.bld_editor import (
        METHOD,
        BlendedLatentDiffusionEditor,
        latent_mask,
    )
    from pnpinversion_tpu_torch.parallel.sweep import BatchedBLD
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    pipe = SDPipeline.create(SD21, seed=0, num_ddim_steps=STEPS)
    yy, xx = np.mgrid[:512, :512]
    masks = np.stack([((yy - 200 - 30 * i) ** 2 + (xx - 260 + 20 * i) ** 2 < (90 + 10 * i) ** 2)
                      .astype(np.float32) for i in range(BATCH)])
    targets = [t for _, t in prompts]
    BlendedLatentDiffusionEditor(_pipe_at(pipe, 2))(METHOD, imgs[0], masks[0], targets[0])
    strip, row = _timed(lambda: BlendedLatentDiffusionEditor(pipe)(METHOD, imgs[0], masks[0],
                                                                   targets[0]))
    _emit(rows, METHOD, {"steps": STEPS, **row, "edit_panel_std": float(strip[:, 1536:].std())})
    lat = np.stack([latent_mask(m, pipe.latent_size) for m in masks])
    cond = torch.stack([pipe.encode_prompt([t]) for t in targets])
    BatchedBLD(_pipe_at(pipe, 2)).edit_batch(imgs, lat, cond)
    _, row = _timed(lambda: BatchedBLD(pipe).edit_batch(imgs, lat, cond))
    _emit(rows, f"batched {METHOD} x{BATCH}", {"steps": STEPS, **row,
                                                 "s_per_image": row["s"] / BATCH})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="p2z,sd,bld")
    ap.add_argument("--inner", type=int, default=100, help="StyleDiffusion's inner steps")
    ap.add_argument("--out", default=None, help="a JSON file for all the runs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_torch_families: no CUDA device", file=sys.stderr)
        return 1
    import subprocess

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    from pnpinversion_tpu_torch.configs import SD14
    from pnpinversion_tpu_torch.ops import build
    from pnpinversion_tpu_torch.ops.flash_attention import BWD_KERNEL, KERNEL
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    build.build([KERNEL, BWD_KERNEL])
    only = set(args.only.split(","))
    rng = np.random.RandomState(4040)
    imgs = (rng.rand(BATCH, 512, 512, 3) * 255).astype(np.uint8)
    prompts = [(s, s.replace("round", "square")) for s in (
        "a round cake with orange frosting on a wooden plate",
        "a big round cake with pink frosting on a glass plate",
        "a tall white round cake on a metal table",
        "one slice of a small round cake with blue frosting")]
    rows = {"card": card}
    if only & {"p2z", "sd"}:
        pipe = SDPipeline.create(SD14, seed=0, num_ddim_steps=STEPS)
        if "p2z" in only:
            p2z_runs(pipe, imgs, prompts, rows)
        if "sd" in only:
            sd_runs(pipe, imgs, prompts, rows, args.inner)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    if "bld" in only:
        bld_runs(imgs, prompts, rows)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
