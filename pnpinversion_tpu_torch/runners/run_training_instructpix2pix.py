"""Train an InstructPix2Pix-style edit-conditioned diffusion model on one GPU:
the port's counterpart of ``runners/run_training_instructpix2pix.py``.

    python -m pnpinversion_tpu_torch.runners.run_training_instructpix2pix \\
        --data_path pairs --output_dir run [--batch_per_step 32] \\
        [--accumulate_grad_batches 4] [--crop_res 256] [--remat] [--resume]

Data: one or more ip2p seeds.json dataset directories (``--data_path``,
repeatable, with ``--data_weight`` mixing them as InstructDiffusion does).
The model: an IP2P pipeline (SD1.4 with the 8-channel UNet; a 4-channel
UNet is zero-extended, the ip2p init) on random weights from ``--seed``
(checkpoints, ``--checkpoint_dir``, are ROADMAP A13). bf16 compute over f32
master weights, accumulation, EMA, ``torch.save`` checkpoints
``<output_dir>/step_<n:08d>.pt`` (``--resume`` continues from the latest),
and a JSONL log ``<output_dir>/train_log.jsonl`` (loss, grad_norm, lr,
s_per_step, and peak_mem_gb after the first step). One device: the JAX
runner's dp/tp mesh and multi-host flags are ROADMAP A12. Runs on ``cuda``
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_path", action="append", required=True,
                   help="ip2p dataset dir (seeds.json layout); repeatable")
    p.add_argument("--data_weight", action="append", type=float, default=None,
                   help="per-dataset sample weight (InstructDiffusion-style)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--checkpoint_dir", default=None,
                   help="a converted SD checkpoint: ROADMAP A13, raises for now")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint in --output_dir")
    p.add_argument("--batch_per_step", type=int, default=32,
                   help="micro-batch per optimizer sub-step (train.yaml: 32)")
    p.add_argument("--accumulate_grad_batches", type=int, default=4)
    p.add_argument("--max_steps", type=int, default=10000)
    p.add_argument("--base_lr", type=float, default=1e-4)
    p.add_argument("--no_scale_lr", action="store_true",
                   help="disable the accum * batch LR scaling")
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--clip_grad", type=float, default=0.0)
    p.add_argument("--uncond_prob", type=float, default=0.05)
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--remat", action="store_true",
                   help="recompute the UNet's activations in the backward (less memory, "
                        "one more forward)")
    p.add_argument("--crop_res", type=int, default=256)
    p.add_argument("--min_resize_res", type=int, default=256)
    p.add_argument("--max_resize_res", type=int, default=256)
    p.add_argument("--flip_prob", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--val_every", type=int, default=0,
                   help="EMA validation-loss cadence; 0 disables")
    p.add_argument("--val_batches", type=int, default=4)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.checkpoint_dir is not None:
        raise NotImplementedError("--checkpoint_dir: loading checkpoints is ROADMAP A13, "
                                  "not ported yet")
    from pnpinversion_tpu_torch.configs import IP2P
    from pnpinversion_tpu_torch.pipeline import SDPipeline
    from pnpinversion_tpu_torch.training.data import EditPairDataset, WeightedConcat, batches
    from pnpinversion_tpu_torch.training.trainer import (
        EditTrainer,
        TrainConfig,
        extend_conv_in,
        step_generator,
    )
    from pnpinversion_tpu_torch.utils.observability import RunLogger

    pipe = SDPipeline.create(IP2P, seed=args.seed, device=args.device)
    model_cfg = pipe.config  # IP2P, or a miniature a test injects through create
    unet = pipe.unet
    if unet.config.in_channels < model_cfg.unet.in_channels:
        unet = extend_conv_in(unet, model_cfg.unet.in_channels)
    cfg = TrainConfig(
        base_lr=args.base_lr, scale_lr=not args.no_scale_lr, warmup_steps=args.warmup_steps,
        weight_decay=args.weight_decay, clip_grad=args.clip_grad,
        accum=args.accumulate_grad_batches, uncond_prob=args.uncond_prob,
        ema_decay=args.ema_decay, remat=args.remat,
        dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32)
    null_ids = pipe.tokenize([""])[0]
    trainer = EditTrainer(model_cfg, {"vae": pipe.vae, "text": pipe.text_encoder}, unet, cfg,
                          args.batch_per_step, null_ids)
    pipe.unet = unet = None  # the trainer holds its own f32 copies: free the others
    if args.resume:
        trainer.restore(directory=args.output_dir)

    def dataset(path, split, flip):
        return EditPairDataset(path, split=split, min_resize_res=args.min_resize_res,
                               max_resize_res=args.max_resize_res, crop_res=args.crop_res,
                               flip_prob=flip)

    train_src = WeightedConcat([dataset(p, "train", args.flip_prob) for p in args.data_path],
                               args.data_weight)
    val_src = WeightedConcat([dataset(p, "val", 0.0) for p in args.data_path], args.data_weight)
    val_every = args.val_every if len(val_src) > 0 else 0
    A, B = args.accumulate_grad_batches, args.batch_per_step

    def device_batch(stream):
        """A * B host items -> {edited, cond_image: (A, B, H, W, 3), ids: (A, B, 77)}."""
        parts = [next(stream) for _ in range(A)]
        return {"edited": np.stack([p["edited"] for p in parts]),
                "cond_image": np.stack([p["cond_image"] for p in parts]),
                "ids": torch.stack([pipe.tokenize(p["edit"]) for p in parts])}

    os.makedirs(args.output_dir, exist_ok=True)
    logger = RunLogger(os.path.join(args.output_dir, "train_log.jsonl"))
    train_stream = batches(train_src, B, seed=args.seed)
    val_stream = batches(val_src, B, seed=args.seed + 1)
    cuda = trainer.device.type == "cuda"
    start = trainer.step
    t0 = time.time()
    for step in range(start, args.max_steps):
        metrics = trainer.train_step(device_batch(train_stream),
                                     step_generator(args.seed, step, trainer.device))
        if (step + 1) % args.log_every == 0 or step == start:
            m = {k: float(v) for k, v in metrics.items()}
            m.update(step=step + 1, lr=trainer.learning_rate(step),
                     s_per_step=(time.time() - t0) / max(1, step + 1 - start))
            if step == start and cuda:  # the footprint once, after the first step
                m["peak_mem_gb"] = round(torch.cuda.max_memory_allocated(trainer.device)
                                         / 2**30, 2)
            logger.log("train", **m)
            print(json.dumps({"train": m}), flush=True)
        if val_every and (step + 1) % val_every == 0:
            gen = step_generator(args.seed + 1, step, trainer.device)
            vl = float(np.mean([float(trainer.val_step(device_batch(val_stream), gen))
                                for _ in range(args.val_batches)]))
            logger.log("val", step=step + 1, loss=vl)
            print(json.dumps({"val": {"step": step + 1, "loss": vl}}), flush=True)
        if args.save_every and (step + 1) % args.save_every == 0:
            trainer.save(args.output_dir)
    if args.max_steps > start:
        logger.log("done", step=args.max_steps, checkpoint=trainer.save(args.output_dir))


if __name__ == "__main__":
    main()
