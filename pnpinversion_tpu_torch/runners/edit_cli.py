"""Single-image instruction editing (InstructPix2Pix family): the port of
``runners/edit_cli.py``.

    python -m pnpinversion_tpu_torch.runners.edit_cli --input IN --output OUT \\
        --edit "make it snowy" [--steps 100] [--cfg-text 7.5] [--cfg-image 1.5] \\
        [--seed S] [--variant ip2p|instructdiff] [--checkpoint_dir C] [--device cpu]

The input is resized so its long side is about ``--resolution``, both sides
snapped to multiples of 64 (``fit_64``), and edited at that aspect ratio; an
empty instruction copies the input through; ``--interactive`` reads one
instruction per line and writes ``<output stem>_<n>.<ext>`` per edit, the
model loaded once. The pipeline is f32 (``configs.IP2P``), as the JAX
tool's; the seed is random when not given.
"""
from __future__ import annotations

import argparse
import math
import os
import random
import sys
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="single-image instruction editing")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--edit", default=None,
                   help="editing instruction (required unless --interactive)")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--checkpoint_dir", default=None,
                   help="an ip2p CompVis .ckpt (or its dir); random weights without")
    p.add_argument("--variant", default="ip2p", choices=["ip2p", "instructdiff"])
    p.add_argument("--cfg-text", type=float, default=7.5)
    p.add_argument("--cfg-image", type=float, default=1.5)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--interactive", action="store_true",
                   help="read one instruction per line, write <output stem>_<n>.<ext> per edit")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p


def fit_64(width: int, height: int, resolution: int):
    """The reference's resize arithmetic (edit_cli.py:87-91): scale so the
    long side is ~resolution, then snap both sides to multiples of 64."""
    factor = resolution / max(width, height)
    factor = math.ceil(min(width, height) * factor / 64) * 64 / min(width, height)
    return int((width * factor) // 64) * 64, int((height * factor) // 64) * 64


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.edit is None and not args.interactive:
        build_parser().error("--edit is required unless --interactive")

    import numpy as np
    import torch
    from PIL import Image, ImageOps

    from pnpinversion_tpu_torch.configs import IP2P
    from pnpinversion_tpu_torch.editors.instruct_editor import instruct_sample
    from pnpinversion_tpu_torch.models.vae import latent_to_image
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    pipe = SDPipeline.create(IP2P, checkpoint_dir=args.checkpoint_dir, num_ddim_steps=args.steps,
                             device=args.device, dtype=torch.float32)
    img = Image.open(args.input).convert("RGB")
    w, h = fit_64(*img.size, args.resolution)
    img = ImageOps.fit(img, (w, h), method=Image.Resampling.LANCZOS)
    with torch.inference_mode():
        image = torch.as_tensor(np.asarray(img), device=pipe.device)
        image_cond = pipe.vae.encode((image.to(pipe.dtype) / 127.5 - 1.0)[None], scale=False)
        text_uncond = pipe.encode_prompt([""])[None]

    @torch.inference_mode()
    def run_one(instruction: str, out_path: str) -> None:
        if instruction == "":
            img.save(out_path)  # edit_cli.py:94-96
            return
        seed = random.randint(0, 100000) if args.seed is None else args.seed
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        z = instruct_sample(pipe.unet, pipe.schedule, image_cond[:, None],
                            pipe.encode_prompt([instruction])[None], text_uncond, args.steps,
                            args.cfg_text, args.cfg_image, gen, args.variant)
        Image.fromarray(latent_to_image(pipe.vae, z[:, 0]).cpu().numpy()[0]).save(out_path)
        print(f"wrote {out_path} (seed {seed})")

    if not args.interactive:
        run_one(args.edit, args.output)
        return
    stem, ext = os.path.splitext(args.output)
    print("instruction per line (empty line = copy input, Ctrl-D to quit):")
    for n, line in enumerate(sys.stdin):
        run_one(line.strip(), f"{stem}_{n}{ext or '.png'}")


if __name__ == "__main__":
    main()
