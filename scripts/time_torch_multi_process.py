"""Seconds and peak memory of the PyTorch port's multi-process paths on one
NVIDIA GPU, with one process and with two processes sharing the card (joined
by gloo: NCCL refuses two ranks on one GPU):

- the sweep: ``runners.run_sweep_sharded`` for directinversion+p2p in bf16,
  x4 a process, at ``--ddim_steps`` (50) DDIM steps, random weights from seed
  0, over ``--images`` images a process (the smoke's cake prompts), after a
  warm-up run in the same processes (2 steps, one x4 batch a process: the
  kernels loaded, cuDNN's plans and the allocator warm). The processes start
  the timed run together (a barrier); each starts editing when its pipeline
  is built (``SDPipeline.create``'s seconds, to a synchronize, excluded). The
  aggregate seconds per image: from the earliest start of editing to the
  last process's end, over every process's images;
- training: ``EditTrainer`` at a global batch of 32 x accumulation 4, 256^2,
  bf16 over f32 masters, SD1.4's UNet widened to 8 channels (random weights
  from seed 0, random images, the unscaled lr 1e-4 as
  ``scripts/time_torch_training.py`` runs it): one process (32 rows a
  microbatch), and two (16 rows each) with ZeRO and without; a warm-up step,
  then ``--steps`` timed steps, each to a synchronize; seconds per optimizer
  step (the slower process's mean) and each process's peak memory.

Prints the card's name and power limit, one JSON line a measurement, then
all of them as one JSON object (also written to ``--out``).

    python scripts/time_torch_multi_process.py [--steps 3] [--images 16] \\
        [--only sweep,train] [--out FILE]
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

BATCH, ACCUM, CROP = 32, 4, 256
WORK = os.path.join(REPO, "build", "time_multi_process")  # git-ignored; removed at the end


def _sweep(rank: int, world: int, spec: dict) -> dict:
    from pnpinversion_tpu_torch.parallel import multihost
    from pnpinversion_tpu_torch.runners import run_sweep_sharded

    def argv(data: str, out: str, steps: int) -> list:
        flags = (["--num_processes", str(world), "--process_id", str(rank),
                  "--coordinator_address", spec["address"], "--dist_backend", "gloo"]
                 if world > 1 else [])
        return ["--method", "directinversion+p2p", "--data_path", data, "--output_path", out,
                "--num_ddim_steps", str(steps), "--edit_category_list", "0", "1"] + flags

    run_sweep_sharded.main(argv(spec["warm"], os.path.join(spec["dir"], "warm_out"), 2))
    multihost.barrier()
    start = time.time()
    with chip_smoke._CreateSpy() as spy:
        done = run_sweep_sharded.main(argv(spec["timed"], os.path.join(spec["dir"], "timed_out"),
                                           spec["ddim_steps"]))
    torch.cuda.synchronize()
    end = time.time()
    return {"images": done["images"], "batch": done["batch"], "start": start, "end": end,
            "load_s": spy.seconds[0], "edit_start": start + spy.seconds[0],
            "s_per_image": (end - start - spy.seconds[0]) / done["images"]}


def _train(rank: int, world: int, zero: bool, steps: int) -> dict:
    import torch.distributed as dist

    from pnpinversion_tpu_torch.configs import IP2P, SD14
    from pnpinversion_tpu_torch.pipeline import SDPipeline
    from pnpinversion_tpu_torch.training import trainer as tr

    pipe = SDPipeline.create(SD14, seed=0)
    unet8 = tr.extend_conv_in(pipe.unet, IP2P.unet.in_channels)
    pipe.unet = None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = tr.TrainConfig(accum=ACCUM, dtype=torch.bfloat16, scale_lr=False, zero=zero)
    trainer = tr.EditTrainer(IP2P, {"vae": pipe.vae, "text": pipe.text_encoder}, unet8, cfg,
                             BATCH, pipe.tokenize([""])[0],
                             group=dist.group.WORLD if world > 1 else None)
    del unet8
    rows = BATCH // world
    rng = np.random.default_rng(rank)
    ids = torch.stack([pipe.tokenize(["make it snowy"] * rows)] * ACCUM)

    def batch():
        img = lambda: rng.uniform(-1, 1, (ACCUM, rows, CROP, CROP, 3)).astype(np.float32)
        return {"edited": img(), "cond_image": img(), "ids": ids}

    m, warm = chip_smoke._sync_time(lambda: trainer.train_step(batch(), tr.step_generator(
        0, 0, trainer.device)))
    times, losses = [], [float(m["loss"])]
    for i in range(steps):
        b = batch()
        m, t = chip_smoke._sync_time(lambda: trainer.train_step(b, tr.step_generator(
            0, 1 + i, trainer.device)))
        times.append(t)
        losses.append(float(m["loss"]))
    if not np.isfinite(losses).all():
        raise AssertionError(f"training losses {losses}")
    out = {"world": world, "zero": zero, "rows_per_rank": rows, "warmup_s": warm,
           "s_per_step": times, "s_per_step_mean": float(np.mean(times)), "losses": losses,
           "moments_gib": sum(2 * 4 * m_.numel() for m_ in trainer.mu) / 2**30,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    del trainer, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rank(rank: int, world: int, spec: dict) -> None:
    """One process of a configuration (spawned): its sweep and its training
    runs in turn; writes its numbers to ``<dir>/w<world>_rank<r>.json``."""
    from pnpinversion_tpu_torch.parallel import multihost

    if world > 1:
        multihost.initialize(spec["address"], world, rank, "gloo", torch.device("cuda", 0))
    out = {}
    try:
        if "sweep" in spec["only"]:
            out["sweep"] = _sweep(rank, world, spec)
        if "train" in spec["only"]:
            for zero in ((True, False) if world > 1 else (True,)):
                out[f"train_zero_{zero}"] = _train(rank, world, zero, spec["steps"])
                multihost.barrier()
    finally:
        multihost.shutdown()
    with open(os.path.join(spec["dir"], f"w{world}_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def run(world: int, spec: dict) -> list:
    import torch.multiprocessing as mp

    from pnpinversion_tpu_torch.parallel import multihost

    spec = dict(spec, address=f"127.0.0.1:{multihost.free_port()}")
    mp.start_processes(_rank, args=(world, spec), nprocs=world, join=True, start_method="spawn")
    return [json.load(open(os.path.join(spec["dir"], f"w{world}_rank{r}.json")))
            for r in range(world)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--images", type=int, default=16, help="timed sweep images a process")
    ap.add_argument("--ddim_steps", type=int, default=50)
    ap.add_argument("--only", default="sweep,train")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from pnpinversion_tpu_torch.ops import build
    from pnpinversion_tpu_torch.ops.flash_attention import (BWD_KERNEL, F32_BWD_KERNEL,
                                                            F32_FWD_KERNEL, KERNEL)

    if not torch.cuda.is_available():
        raise SystemExit("time_torch_multi_process: no CUDA device")
    out = {"card": chip_smoke.card_line()}
    print(out["card"], flush=True)
    build.build([KERNEL, BWD_KERNEL, F32_BWD_KERNEL, F32_FWD_KERNEL])  # before any process starts
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        results = {}
        for world in (1, 2):
            d = os.path.join(WORK, f"w{world}")
            os.makedirs(d)
            spec = {"dir": d, "only": args.only.split(","), "steps": args.steps,
                    "ddim_steps": args.ddim_steps,
                    "warm": chip_smoke._mini_pie_bench(os.path.join(d, "warm"),
                                                       chip_smoke.BATCH * world, 512),
                    "timed": chip_smoke._mini_pie_bench(os.path.join(d, "timed"),
                                                        args.images * world, 512)}
            results[world] = run(world, spec)
        if "sweep" in args.only:
            for world, ranks in results.items():
                rows = [r["sweep"] for r in ranks]
                window = max(r["end"] for r in rows) - min(r["edit_start"] for r in rows)
                row = {"world": world, "images": sum(r["images"] for r in rows),
                       "ddim_steps": args.ddim_steps, "batch": rows[0]["batch"],
                       "s_per_image_aggregate": window / sum(r["images"] for r in rows),
                       "per_rank": rows}
                out[f"sweep_w{world}"] = row
                print("sweep", json.dumps(row), flush=True)
        if "train" in args.only:
            for world, ranks in results.items():
                for key in sorted(k for k in ranks[0] if k.startswith("train")):
                    per = [r[key] for r in ranks]
                    row = {"world": world, "zero": per[0]["zero"], "batch": BATCH,
                           "accumulate_grad_batches": ACCUM, "crop": CROP,
                           "s_per_step": max(p["s_per_step_mean"] for p in per),
                           "peak_mem_gib_per_rank": [p["peak_mem_gib"] for p in per],
                           "per_rank": per}
                    out[f"train_w{world}_zero_{per[0]['zero']}"] = row
                    print("train", json.dumps(row), flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
