"""The PIE-Bench runners' shared loop (port of ``pnpinversion_tpu/cli.py``).

``run_benchmark`` walks ``mapping_file.json``, filters the categories, skips
the outputs that exist (so a sweep restarts where it stopped), seeds numpy
with 1234 before each image, logs each image through ``RunLogger`` and saves
each method's 4-panel strip under
``<output_path>/<method folder>/annotation_images/<relative image path>``.
``standard_argparser`` takes the JAX runners' flags, plus ``--device``
(``cuda`` unless ``cpu`` is asked for; without CUDA it raises). ``--quant
w8`` stores the UNet's matmul weights int8 (``ops/quant.py``; without the
flag ``PNPI_QUANT`` decides, as in the JAX package); ``--profile_dir``
writes a ``torch.profiler`` trace of the first edited image (the sweep's:
of its first chunk), the program's ``pnpi.*`` spans in it, and the spans and
counters again, the strip writer's among them, in ``spans_<pid>.json``
(``utils/observability.py``). The JAX module's compile-cache set-up has no
counterpart.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
from PIL import Image

from pnpinversion_tpu_torch.data.pie_bench import PieBenchDataset
from pnpinversion_tpu_torch.utils.device import resolve_device
from pnpinversion_tpu_torch.utils import observability
from pnpinversion_tpu_torch.utils.observability import RunLogger, span


def standard_argparser(default_methods: Sequence[str]) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--rerun_exist_images", action="store_true")
    p.add_argument("--data_path", type=str, default="data")
    p.add_argument("--mapping_file", type=str, default=None,
                   help="override the mapping file, e.g. "
                        "data/mapping_file_ti2i_benchmark.json for the 55-image TI2I benchmark")
    p.add_argument("--output_path", type=str, default="output")
    p.add_argument("--edit_category_list", nargs="+", type=str,
                   default=[str(i) for i in range(10)])
    p.add_argument("--edit_method_list", nargs="+", type=str, default=list(default_methods))
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="local weights: an HF pipeline dir (unet/ vae/ text_encoder/ "
                        "[tokenizer/]) or a CompVis .ckpt; random weights without")
    p.add_argument("--num_ddim_steps", type=int, default=50)
    p.add_argument("--run_log", type=str, default=None,
                   help="JSONL run log (per-image timings/errors)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="torch.profiler trace dir (profiles the first edited image, "
                        "or the sweep's first chunk)")
    p.add_argument("--quant", type=str, default=None, choices=["none", "w8"],
                   help="weight-only int8 UNet weights (ops/quant.py); unset: $PNPI_QUANT")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default; raises without CUDA) or cpu")
    return p


def check_args(args) -> None:
    """Refuses a device that is not there (``resolve_device``)."""
    resolve_device(getattr(args, "device", None))


def make_pipeline(args, config):
    """The per-image runners' pipeline: f32, as the JAX runners create theirs
    (full f32 on the card), from ``--checkpoint_dir`` or random weights, on
    ``--device``, w8 with ``--quant w8``."""
    import torch

    from pnpinversion_tpu_torch.pipeline import SDPipeline

    check_args(args)
    return SDPipeline.create(config, num_ddim_steps=args.num_ddim_steps,
                             checkpoint_dir=args.checkpoint_dir, device=args.device,
                             dtype=torch.float32, quantize=getattr(args, "quant", None))


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]):
    """A ``torch.profiler`` trace (CPU and CUDA activity) of the block,
    written to ``trace_dir`` as a Chrome trace, and beside it the program's
    spans and counters of the block (``observability.write``); nothing
    without a dir."""
    if not trace_dir:
        yield
        return
    import torch

    os.makedirs(trace_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    since, before = time.time_ns(), observability.counters()
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}.json"))
    observability.write(os.path.join(trace_dir, f"spans_{os.getpid()}.json"), since, before)


def save_strip(strip: np.ndarray, save_path: str) -> None:
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    Image.fromarray(strip).save(save_path)


def run_benchmark(args, edit_fn: Callable, image_save_paths: Dict[str, str]) -> None:
    """edit_fn(edit_method, item) -> the strip, uint8 (H, 4W, 3)."""
    logger = RunLogger(getattr(args, "run_log", None))
    profile_dir = getattr(args, "profile_dir", None)
    profiled = False
    dataset = PieBenchDataset(args.data_path, mapping_file=getattr(args, "mapping_file", None))
    for item in dataset.items(args.edit_category_list):
        for edit_method in args.edit_method_list:
            rel = item.rel_output_path(os.path.join(args.data_path, "annotation_images"))
            save_path = os.path.join(args.output_path, image_save_paths[edit_method],
                                     "annotation_images", rel)
            if os.path.exists(save_path) and not args.rerun_exist_images:
                print(f"skip image [{item.image_path}] with [{edit_method}]")
                logger.log("image_skip", key=item.key, method=edit_method)
                continue
            print(f"editing image [{item.image_path}] with [{edit_method}]")
            np.random.seed(1234)
            with logger.image(item.key, edit_method):
                with profile_trace(None if profiled else profile_dir), \
                        span("pnpi.runner.image", request=item.key, method=edit_method):
                    strip = edit_fn(edit_method, item)
                profiled = profiled or bool(profile_dir)
            with span("pnpi.runner.save_strip", request=item.key):
                save_strip(strip, save_path)
            print("finish")
