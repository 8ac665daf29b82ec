"""MFU of the PyTorch port's main path on one NVIDIA GPU: the counterpart of
the JAX package's ``scripts/mfu.py`` and ``scripts/_xprof.py``.

``directinversion+p2p`` (SD1.4, bf16, random weights from seed 0, 512², the
cake prompts, guidance 7.5, ``--steps`` DDIM steps) through the single-image
editor (``P2PEditor``) and through ``BatchedDirectInversionP2P`` on
``--batch`` images. For each:

- FLOPs per image: the port's count (``utils/mfu.py::edit_flops``: a
  2-step edit counted call by call, extended to ``--steps``);
- warm seconds per image: host clock to a ``torch.cuda.synchronize()``,
  after a warm-up edit;
- a torch.profiler trace of one more warm edit: the device's busy time (the
  union of its kernels' intervals), its tensor-core time (GEMM, convolution
  and flash kernels, by name: ``utils/mfu.py::TENSOR_CORE_KERNEL``), its
  time by kind of kernel and its idle share (1 - busy / warm seconds);
- MFU against the bf16 dense peak, 989 TFLOP/s: over the warm wall time,
  over the device's busy time and over its tensor-core time.

The ×1 edit embeds its prompts (the text tower is in its count and its
time); the batched call takes them embedded, as the sweep does. Fails when
the trace holds no kernel. Prints the card's name and power limit
(``nvidia-smi``), one JSON line a path, then all of it as one JSON object
(also written to ``--out``).

    python3 scripts/mfu_torch.py [--steps 50] [--batch 4] [--out FILE]
    python3 scripts/mfu_torch.py --device cpu --config TINY   # the plumbing: FLOPs, no MFU
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pnpinversion_tpu_torch.utils import mfu  # noqa: E402


def measure(pipe, images: int, steps: int, device: str) -> dict:
    """FLOPs per image; on the card also seconds, the trace and MFU."""
    count = mfu.edit_flops(pipe, steps=steps, images=images)
    out = {"images": images, "steps": steps, "flops_per_image": count.per_image.total,
           "flops_per_image_by_kind": count.per_image.as_dict(),
           "window_steps": count.window_steps}
    if device != "cuda":
        return out
    run = mfu.main_path_edit(pipe, images)
    _, warm = mfu.sync_time(run)
    _, wall = mfu.sync_time(run)
    traced_wall, activity = mfu.trace_device(run)
    out.update(warmup_s=warm, **mfu.mfu_report(count.total.total, images, wall, traced_wall,
                                               activity))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--config", default="SD14", choices=("SD14", "TINY"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("mfu_torch: no CUDA device (--device cpu --config TINY checks the plumbing)",
              file=sys.stderr)
        return 1
    from pnpinversion_tpu_torch import configs
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    out = {"config": args.config, "device": args.device}
    if args.device == "cuda":
        from pnpinversion_tpu_torch.ops import build
        from pnpinversion_tpu_torch.ops.flash_attention import KERNEL

        out.update(card=mfu.card_line(), kind=torch.cuda.get_device_name(0),
                   torch=torch.__version__, cuda=torch.version.cuda)
        print(out["card"], flush=True)
        build.build([KERNEL])
    pipe = SDPipeline.create(getattr(configs, args.config), seed=0, num_ddim_steps=args.steps,
                             device=args.device)
    out["dtype"] = str(pipe.dtype)
    for name, images in (("x1", 1), ("batched", args.batch)):
        out[name] = measure(pipe, images, args.steps, args.device)
        print(name, json.dumps(out[name]), flush=True)
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
