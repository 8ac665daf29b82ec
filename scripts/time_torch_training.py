"""Seconds per optimizer step and peak memory of the PyTorch port's
InstructPix2Pix training on one NVIDIA GPU, and seconds per generated pair of
its dataset creation:

- ``EditTrainer`` at the JAX runner's defaults: batch_per_step 32,
  accumulate_grad_batches 4, 256^2 crops, bf16 compute over f32 master
  weights, the SD1.4 UNet widened to 8 channels (random weights from seed 0,
  random images: a step's time does not depend on the pixels), with and
  without remat; a configuration that does not fit on the card is reported
  as such (its out-of-memory error), not skipped in silence. The lr is the
  unscaled base lr (1e-4): the runner's scaled one (accum x batch x 1e-4 =
  0.0128) drives random weights to NaN within a few steps, which times the
  same but trains nothing, so every loss here must stay finite;
- the bf16 flash kernels' share of one training step, from a torch.profiler
  trace (each kernel's device time, and their sum against the step's wall
  time and against the sum of every kernel's time);
- ``generate_for_prompt`` at 100 Euler steps, 4 candidates per sampler call
  (16 UNet rows at 512^2) and the full-width CLIP filter: seconds per pair.

Each timed call ends in ``torch.cuda.synchronize()`` and follows a warm-up.
Prints the card's name and power limit first, then one JSON line per
measurement, then all of them as one JSON object (also written to ``--out``).

    python scripts/time_torch_training.py [--steps 3] [--only train,pairs] [--out FILE]
"""
from __future__ import annotations

import argparse
import collections
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

BATCH, ACCUM, CROP = 32, 4, 256
PAIR_STEPS, PAIR_BATCH = 100, 4
SITES = 5  # the flash sites of a 256^2 crop (32^2: down_blocks[0] x2, up_blocks[3] x3)
INSTRUCTIONS = ("make it snowy", "turn it into a pencil sketch", "add a sunset",
                "make it autumn")
PROMPT = {"caption": "a round cake with orange frosting on a wooden plate",
          "edit": "make it a chocolate cake",
          "output": "a round chocolate cake on a wooden plate"}


def card() -> str:
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def counts() -> dict:
    from pnpinversion_tpu_torch.ops import flash_attention as fa

    return {"fwd": fa.flash_attention_fwd.launches,
            **{w.__name__.replace("flash_attention_bwd_", ""): w.launches
               for w in fa.BWD_WRAPPERS}}


def pairs_phase(pipe) -> dict:
    """One prompt's 4 candidates at 100 Euler steps (after a warm-up at 2),
    scored by the full-width CLIP filter, every pair kept."""
    from pnpinversion_tpu_torch.training import dataset_creation as dc

    root = os.path.join(REPO, "build", "time_training_pairs")
    clip = dc.PairClipFilter(tokenizer=pipe.tokenizer, device=pipe.device)
    keep = dc.FilterThresholds(-1.0, -1.0, -1.0)
    kw = dict(n_samples=PAIR_BATCH, max_out_samples=PAIR_BATCH, batch=PAIR_BATCH, thresholds=keep)
    _, t_warm = synced(lambda: dc.generate_for_prompt(PROMPT, f"{root}/warm", dc.PairGenerator(
        pipe, 2), clip, **kw))
    gen = dc.PairGenerator(pipe, PAIR_STEPS)
    before = counts()
    kept, t = synced(lambda: dc.generate_for_prompt(PROMPT, f"{root}/timed", gen, clip, **kw))
    launches = counts()["fwd"] - before["fwd"]
    pairs, t_sample = synced(lambda: gen(
        PROMPT["caption"], PROMPT["output"], [1, 2, 3, 4], np.full(PAIR_BATCH, 7.5, np.float32),
        np.full(PAIR_BATCH, 0.5, np.float32)))
    _, t_clip = synced(lambda: clip.scores(pairs, PROMPT["caption"], PROMPT["output"]))
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    return {"euler_steps": PAIR_STEPS, "candidates_per_call": PAIR_BATCH,
            "unet_rows": 4 * PAIR_BATCH, "warmup_2_steps_s": t_warm, "generate_for_prompt_s": t,
            "s_per_pair": t / kept, "pairs": kept, "sample_and_decode_s": t_sample,
            "s_per_sampler_step": t_sample / PAIR_STEPS, "clip_scores_s": t_clip,
            "flash_fwd_launches": launches, "flash_fwd_launches_want": 10 * PAIR_STEPS}


def _batches(tokenize, n: int) -> list:
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        img = lambda: rng.uniform(-1, 1, (ACCUM, BATCH, CROP, CROP, 3)).astype(np.float32)
        ids = torch.stack([tokenize([INSTRUCTIONS[(a + i) % len(INSTRUCTIONS)]
                                     for i in range(BATCH)]) for a in range(ACCUM)])
        out.append({"edited": img(), "cond_image": img(), "ids": ids})
    return out


def train_phase(pipe, steps: int) -> dict:
    """Warm-up step, then ``steps`` timed optimizer steps without and with
    remat, each with its peak memory and launches; then one step under the
    profiler (without remat if it fits)."""
    from torch.profiler import ProfilerActivity, profile

    from pnpinversion_tpu_torch.configs import IP2P
    from pnpinversion_tpu_torch.training import trainer as tr

    unet8 = tr.extend_conv_in(pipe.unet, IP2P.unet.in_channels)
    pipe.unet = None
    cfg = tr.TrainConfig(accum=ACCUM, dtype=torch.bfloat16, scale_lr=False)
    trainer = tr.EditTrainer(IP2P, {"vae": pipe.vae, "text": pipe.text_encoder}, unet8, cfg,
                             BATCH, pipe.tokenize([""])[0])
    del unet8
    gc.collect()
    torch.cuda.empty_cache()
    data = _batches(pipe.tokenize, steps + 1)
    out = {"batch_per_step": BATCH, "accumulate_grad_batches": ACCUM, "crop_res": CROP,
           "state_gib": sum(4 * 4 * p.numel() for p in trainer.params) / 2**30}
    fits = {}
    for remat in (False, True):
        trainer.cfg = dataclasses.replace(cfg, remat=remat)
        torch.cuda.reset_peak_memory_stats()
        row = {"allocated_before_gib": torch.cuda.memory_allocated() / 2**30}
        try:
            m, row["warmup_s"] = synced(lambda: trainer.train_step(
                data[0], tr.step_generator(0, 0, trainer.device)))
            before, times, losses = counts(), [], [float(m["loss"])]
            for i in range(steps):
                m, t = synced(lambda: trainer.train_step(
                    data[1 + i], tr.step_generator(0, 1 + i, trainer.device)))
                times.append(t)
                losses.append(float(m["loss"]))
            after = counts()
            if not np.isfinite(losses).all():
                raise AssertionError(f"training losses {losses}")
            row.update(fits=True, s_per_step=times, s_per_step_mean=float(np.mean(times)),
                       losses=losses, grad_norm=float(m["grad_norm"]),
                       launches_per_step={k: (after[k] - before[k]) / steps for k in after},
                       launches_per_step_want={"fwd": SITES * ACCUM * (2 if remat else 1),
                                               "backward kernels each": SITES * ACCUM})
        except torch.cuda.OutOfMemoryError as e:  # the finding is that it does not fit
            row.update(fits=False, error=str(e).splitlines()[0][:300])
            for p in trainer.params:
                p.grad = None
        row["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        gc.collect()
        torch.cuda.empty_cache()
        out["remat" if remat else "no_remat"] = row
        fits[remat] = row["fits"]
        print("train", json.dumps({"remat": remat, **row}), flush=True)

    remat = not fits[False]
    if not fits[remat]:
        return out
    trainer.cfg = dataclasses.replace(cfg, remat=remat)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = synced(lambda: trainer.train_step(data[-1], tr.step_generator(0, 99,
                                                                                 trainer.device)))
    us, n = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us[e.name] += e.time_range.elapsed_us()
            n[e.name] += 1
    if not us:
        raise AssertionError("torch.profiler recorded no device kernel")
    total = sum(us.values()) / 1e6
    flash = {k: v / 1e6 for k, v in us.items() if "flash_" in k}
    by_kernel = collections.defaultdict(lambda: [0.0, 0])
    for k, v in flash.items():
        name = next(x for x in ("flash_fwd_wgmma_kernel", "flash_bwd_prep_kernel",
                                "flash_bwd_dq_convert_kernel", "flash_bwd_kernel", "flash_")
                    if x in k)
        by_kernel[name][0] += v
        by_kernel[name][1] += n[k]
    flash_s = sum(flash.values())
    out["trace"] = {"remat": remat, "traced_step_s": wall, "kernel_time_sum_s": total,
                    "flash_s": flash_s, "flash_share_of_step_wall": flash_s / wall,
                    "flash_share_of_kernel_time_sum": flash_s / total,
                    "flash_by_kernel": {k: {"s": v[0], "launches": v[1],
                                            "ms_per_launch": v[0] * 1e3 / v[1]}
                                        for k, v in by_kernel.items()},
                    "top": [{"kernel": k[:90], "s": v / 1e6} for k, v in us.most_common(10)]}
    print("trace", json.dumps(out["trace"]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=3, help="timed optimizer steps per setting")
    ap.add_argument("--only", default="pairs,train")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_torch_training: no CUDA device", file=sys.stderr)
        return 1
    from pnpinversion_tpu_torch.configs import SD14
    from pnpinversion_tpu_torch.ops import build
    from pnpinversion_tpu_torch.ops.flash_attention import BWD_KERNEL, KERNEL
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    line = card()
    print(line, flush=True)
    build.build([KERNEL, BWD_KERNEL])
    results = {"card": line, "torch": torch.__version__, "cuda": torch.version.cuda}
    pipe = SDPipeline.create(SD14, seed=0)
    only = args.only.split(",")
    if "pairs" in only:
        results["pairs"] = pairs_phase(pipe)
        print("pairs", json.dumps(results["pairs"]), flush=True)
    if "train" in only:
        results["train"] = train_phase(pipe, args.steps)
    print(json.dumps(results), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
