"""Generate InstructPix2Pix training pairs: P2P sampling + CLIP filtering, the
port's counterpart of ``runners/run_dataset_creation.py``.

    python -m pnpinversion_tpu_torch.runners.run_dataset_creation \\
        --prompts_file prompts.jsonl --out_dir pairs [--model sd14|sd21] \\
        [--steps 100] [--n_samples 100] [--batch 4] [--dtype bf16|f32]

For each {"caption", "edit", "output"} record, candidate pairs are sampled
with self-attention prompt-to-prompt sharing between the caption and the
output prompt (``--batch`` candidates per UNet call, 4 rows each), scored
with CLIP, filtered by the thresholds, and the best ``--max_out_samples``
written in the seeds.json layout that ``run_training_instructpix2pix``
reads. Prompts that already have metadata.jsonl are skipped;
``--n_partitions``/``--partition`` split the prompts across invocations
(then ``--prepare_only`` once at the end); ``--seed`` makes the candidates'
seeds, thresholds and guidance reproducible. Random weights: loading
checkpoints (``--checkpoint_dir``) is ROADMAP A13. Runs on ``cuda`` unless
``--device cpu``.
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
    p.add_argument("--out_dir", required=True)
    p.add_argument("--prompts_file", required=True,
                   help='.jsonl of {"caption","edit","output"} records')
    p.add_argument("--checkpoint_dir", default=None,
                   help="a converted checkpoint: ROADMAP A13, raises for now")
    p.add_argument("--model", default="sd14", choices=["sd14", "sd21"])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--n_samples", type=int, default=100,
                   help="candidates per prompt before CLIP filtering")
    p.add_argument("--max_out_samples", type=int, default=4)
    p.add_argument("--n_partitions", type=int, default=1)
    p.add_argument("--partition", type=int, default=0)
    p.add_argument("--min_p2p", type=float, default=0.1)
    p.add_argument("--max_p2p", type=float, default=0.9)
    p.add_argument("--min_cfg", type=float, default=7.5)
    p.add_argument("--max_cfg", type=float, default=15.0)
    p.add_argument("--clip_threshold", type=float, default=0.2)
    p.add_argument("--clip_dir_threshold", type=float, default=0.2)
    p.add_argument("--clip_img_threshold", type=float, default=0.7)
    p.add_argument("--batch", type=int, default=4, help="candidate pairs per UNet call")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--prepare_only", action="store_true",
                   help="only (re)write seeds.json from existing prompt dirs")
    p.add_argument("--no_prepare", action="store_true",
                   help="skip writing seeds.json (multi-partition runs)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    from pnpinversion_tpu_torch.training import dataset_creation as dc

    if args.prepare_only:
        print(json.dumps({"seeds_json": dc.prepare_dataset(args.out_dir)}), flush=True)
        return
    if args.checkpoint_dir is not None:
        raise NotImplementedError("--checkpoint_dir: loading checkpoints is ROADMAP A13, "
                                  "not ported yet")
    from pnpinversion_tpu_torch.configs import SD14, SD21
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    pipe = SDPipeline.create(SD14 if args.model == "sd14" else SD21, device=args.device,
                             dtype=dtype)
    generator = dc.PairGenerator(pipe, args.steps)
    clip_filter = dc.PairClipFilter(tokenizer=pipe.tokenizer, device=pipe.device)
    thresholds = dc.FilterThresholds(clip_threshold=args.clip_threshold,
                                     clip_dir_threshold=args.clip_dir_threshold,
                                     clip_img_threshold=args.clip_img_threshold)
    part = dc.partition_prompts(dc.load_prompts(args.prompts_file), args.n_partitions,
                                args.partition)
    os.makedirs(args.out_dir, exist_ok=True)
    print(json.dumps({"partition": args.partition, "n_partitions": args.n_partitions,
                      "prompts": len(part)}), flush=True)
    for i, prompt in part:
        t0 = time.time()
        kept = dc.generate_for_prompt(
            prompt, os.path.join(args.out_dir, f"{i:07d}"), generator, clip_filter,
            n_samples=args.n_samples, max_out_samples=args.max_out_samples,
            min_p2p=args.min_p2p, max_p2p=args.max_p2p, min_cfg=args.min_cfg,
            max_cfg=args.max_cfg, thresholds=thresholds, batch=args.batch,
            rng=np.random.default_rng(np.random.SeedSequence([args.seed, i])))
        print(json.dumps({"prompt": i, "kept": kept, "seconds": round(time.time() - t0, 2)}),
              flush=True)
    if not args.no_prepare:
        print(json.dumps({"seeds_json": dc.prepare_dataset(args.out_dir)}), flush=True)


if __name__ == "__main__":
    main()
