"""Seconds per image of the PyTorch port's batched directinversion+p2p edit
at several batch sizes, on one GPU.

For each N: ``BatchedDirectInversionP2P.edit_batch`` on N images (SD1.4,
512² (the config's size), the cake edit of ``chip_smoke.py``, random weights from seed 0, bf16),
a warm-up batch, then ``--reps`` timed batches (host clock around each, to a
``torch.cuda.synchronize``) with fresh images; prints one JSON line per N:
seconds per batch and per image (median), their spread, and peak memory.

    python3 scripts/probe_torch_batch.py [--sizes 1 2 4 8] [--steps 50] [--reps 2]

Needs one CUDA device; builds the port's kernels first.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_batch: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import SRC, TAR, _cake_batch
    from pnpinversion_tpu_torch.configs import SD14
    from pnpinversion_tpu_torch.parallel.sweep import BatchedDirectInversionP2P
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    pipe = SDPipeline.create(SD14, seed=0, num_ddim_steps=args.steps)
    sweep = BatchedDirectInversionP2P(pipe)
    size = pipe.config.image_size
    rng = np.random.RandomState(0)
    for n in args.sizes:
        spec, cond, uncond, tensors = _cake_batch(pipe, [(SRC, TAR)] * n)

        def batch():
            imgs = (rng.rand(n, size, size, 3) * 255).astype(np.uint8)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sweep.edit_batch(spec, imgs, cond, uncond, 7.5, tensors)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        warm = batch()
        torch.cuda.reset_peak_memory_stats()
        times = [batch() for _ in range(args.reps)]
        print("batch", json.dumps({
            "images": n, "steps": args.steps, "prompts": [SRC, TAR], "warmup_s": warm,
            "batch_s": statistics.median(times), "s_per_image": statistics.median(times) / n,
            "batch_s_spread": max(times) - min(times),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
