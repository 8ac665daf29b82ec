"""The port's sweep-then-evaluate rehearsal, as a user runs it: a mini
PIE-Bench swept with each method by ``run_sweep_sharded``, then scored by
``evaluate --sharded``, each a fresh process, timed end to end (the port's
counterpart of ``scripts/rehearsal.py``, which drives the JAX CLI).

    python3 scripts/rehearse_torch.py [--images 16] [--methods M ...] \\
        [--workdir build/rehearsal] [--out docs/rehearsal_torch.json] [--device cuda] \\
        [--timeout 3000]

It first writes the seeded stand-ins a user would bring (``data/seeded.py``):
the mini PIE-Bench (``--images`` 512^2 images) and, once, an SD1.4 HF
directory and an SD2.1 one (blended-latent-diffusion's model) of seeded
weights in f16 safetensors with a BPE vocabulary for the prompts, so every
sweep loads its weights as a user's does. The kernels are built before the
first sweep, so no sweep's time holds the build. Each sweep runs at the
runner's defaults (batch per call: 4 for the light P2P family on the card,
else 1; bf16 on the card) at the reference's STEPS = 50 DDIM steps; the
evaluator runs its own metrics with random weights (no metric directory
here). The test runs it at TINY with smaller STEPS and SIZE and the metrics
that need no mask (METRICS).

The report, printed and written to ``--out``, has the keys of
``docs/rehearsal.json``: per method ``wall_s`` (the process's, its load
included), ``images_done``, ``rc``, ``first_image_gap_s`` and
``steady_s_per_image`` from the sweep's ``image_done`` events (the strips of
one batched call land together, and each event names its call's chunk: the
gaps between chunks, over the largest chunk's size, are the per-image gaps;
the first gap and the median of the rest); ``eval`` with ``wall_s``,
``method_image_pairs`` and ``s_per_pair`` (its CSV is
``--workdir``/rehearsal_eval.csv); ``end_to_end_wall_s`` and
``steady_sweep_s_per_image_avg``; and the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
them. A process that fails leaves its ``stderr_tail``, and the script exits
non-zero once the report is written. It runs on the card unless ``--device
cpu`` is asked.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from pnpinversion_tpu_torch.configs import SD14, SD21  # noqa: E402
from pnpinversion_tpu_torch.data import seeded  # noqa: E402
from pnpinversion_tpu_torch.evaluation.evaluate import all_tgt_image_folders  # noqa: E402

DEFAULT_METHODS = ["directinversion+p2p", "directinversion+masactrl",
                   "blended-latent-diffusion"]
PYTHON = [sys.executable]  # the interpreter (and its arguments) of every step's process
STEPS = 50  # DDIM steps of every sweep
SIZE = 512  # the images' side
METRICS = None  # the evaluator's metrics (None: its own list)


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "no card"


def gaps(run_log: str):
    """(per-image gaps between the sweep's chunks, the ``image_done`` events'
    count): a chunk's strips (one batched call, the events' ``chunk``) land
    together, so the gap from one chunk's first strip to the next's, over
    the largest chunk's size, is a gap per image."""
    starts, sizes = {}, collections.Counter()
    if os.path.exists(run_log):
        with open(run_log) as f:
            for rec in map(json.loads, f):
                if rec.get("event") == "image_done":
                    starts.setdefault(rec["chunk"], rec["ts"])
                    sizes[rec["chunk"]] += 1
    ts, size = sorted(starts.values()), max(sizes.values(), default=1)
    return [(b - a) / size for a, b in zip(ts, ts[1:])], sum(sizes.values())


def eval_key(method: str) -> str:
    """The evaluator's key of a method's folder: the first PIE-Bench group of
    its registry that lists the method."""
    return next(k for k in all_tgt_image_folders() if k.split("_", 1)[1] == method)


def run_step(module: str, args: list, timeout: float) -> tuple:
    """``python -m module args`` in a fresh process from the repo's root:
    (return code, wall seconds, stderr's tail)."""
    t0 = time.time()
    try:
        proc = subprocess.run([*PYTHON, "-m", module, *args], capture_output=True, text=True,
                              timeout=timeout, cwd=REPO)
        rc, tail = proc.returncode, proc.stderr[-1500:]
    except subprocess.TimeoutExpired as exc:
        rc, tail = 124, f"timed out after {timeout} s: {str(exc.stderr)[-1400:]}"
    return rc, time.time() - t0, tail


def write_weights(root: str, device: str, prompts) -> dict:
    """The seeded SD1.4 and SD2.1 HF directories under ``root`` (written
    once): {config name: directory}."""
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    dirs = {}
    for config, seed in ((SD14, 13), (SD21, 14)):
        path = os.path.join(root, config.name)
        if not os.path.exists(os.path.join(path, "done")):
            shutil.rmtree(path, ignore_errors=True)
            pipe = SDPipeline.create(config, seed=seed, device=device, dtype=torch.float32)
            seeded.write_hf_checkpoint(path, {"unet": pipe.unet, "vae": pipe.vae,
                                              "text": pipe.text_encoder})
            seeded.bpe_vocab(os.path.join(path, "tokenizer"), prompts)
            del pipe
            open(os.path.join(path, "done"), "w").close()
        dirs[config.name] = path
    return dirs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=16)
    ap.add_argument("--methods", nargs="+", default=DEFAULT_METHODS)
    ap.add_argument("--workdir", default=os.path.join(REPO, "build", "rehearsal"))
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "rehearsal_torch.json"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=3000.0, help="seconds a step may take")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("rehearse_torch: no CUDA device (--device cpu runs it on the host)")

    t_all = time.time()
    data = os.path.join(args.workdir, "data")
    outroot = os.path.join(args.workdir, "out")
    shutil.rmtree(outroot, ignore_errors=True)
    if not os.path.exists(os.path.join(data, "mapping_file.json")):
        seeded.mini_pie_bench(args.workdir, args.images, SIZE)
    with open(os.path.join(data, "mapping_file.json")) as f:
        n_items = len(json.load(f))
    prompts = [t for p in seeded.PROMPTS for t in p[:3]]
    t0 = time.time()
    weights = write_weights(os.path.join(args.workdir, "weights"), args.device, prompts)
    report = {"card": card(), "device": args.device, "images": n_items, "steps": STEPS,
              "setup_s": round(time.time() - t0, 1), "methods": {}}
    if args.device == "cuda":
        from pnpinversion_tpu_torch.ops import build
        from pnpinversion_tpu_torch.ops.flash_attention import (BWD_KERNEL, F32_BWD_KERNEL,
                                                                F32_FWD_KERNEL, KERNEL)

        t0 = time.time()
        build.build([KERNEL, BWD_KERNEL, F32_BWD_KERNEL, F32_FWD_KERNEL])
        report["kernel_build_s"] = round(time.time() - t0, 1)

    failed = False
    steady_total = 0.0
    for method in args.methods:
        log = os.path.join(args.workdir, f"log_{method}.jsonl")
        if os.path.exists(log):
            os.remove(log)
        ckpt = weights["sd21" if method == "blended-latent-diffusion" else "sd14"]
        rc, wall, tail = run_step("pnpinversion_tpu_torch.runners.run_sweep_sharded", [
            "--method", method, "--data_path", data, "--output_path", outroot,
            "--checkpoint_dir", ckpt, "--num_ddim_steps", str(STEPS), "--run_log", log,
            "--device", args.device], args.timeout)
        g, n = gaps(log)
        steady = sorted(g[1:])[len(g[1:]) // 2] if len(g) > 1 else None
        rec = {"wall_s": round(wall, 1), "images_done": n, "rc": rc,
               "first_image_gap_s": round(g[0], 3) if g else None,
               "steady_s_per_image": round(steady, 3) if steady else None}
        if rc != 0:
            rec["stderr_tail"] = tail
            failed = True
        else:
            steady_total += steady * n if steady else wall
        report["methods"][method] = rec
        print(json.dumps({method: rec}), flush=True)

    tgt = [eval_key(m) for m in args.methods if report["methods"][m]["rc"] == 0]
    csv_path = os.path.join(args.workdir, "rehearsal_eval.csv")
    rc, wall, tail = run_step("pnpinversion_tpu_torch.evaluation.evaluate", [
        "--annotation_mapping_file", os.path.join(data, "mapping_file.json"),
        "--src_image_folder", os.path.join(data, "annotation_images"),
        "--output_root", outroot, "--tgt_methods", *tgt, "--result_path", csv_path,
        "--sharded", "--device", args.device]
        + (["--metrics", *METRICS] if METRICS else []), args.timeout)
    pairs = n_items * len(tgt)
    report["eval"] = {"wall_s": round(wall, 1), "rc": rc, "method_image_pairs": pairs,
                      "s_per_pair": round(wall / max(pairs, 1), 3)}
    if rc != 0:
        report["eval"]["stderr_tail"] = tail
        failed = True
    report["end_to_end_wall_s"] = round(time.time() - t_all, 1)
    report["steady_sweep_s_per_image_avg"] = round(steady_total / max(pairs, 1), 3)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    print(json.dumps(report), flush=True)
    if failed:
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
