"""How far the UNet's stride-2 downsample padding moves its output (ROADMAP C1).

The JAX package's UNet pads its stride-2 downsample convolutions with XLA's
"SAME" split, (0 before, 1 after), and the port does the same. diffusers'
``Downsample2D``, which the real SD1.x/2.x weights were trained with, pads
(1, 1). This probe writes a seeded TINY pipeline as an HF directory (the
port's safetensors writer), loads it through ``SDPipeline.create(
checkpoint_dir=...)``, and runs one UNet call twice on the same inputs: as
the port computes it, and with every downsample convolution replaced by
``F.conv2d(..., stride=2, padding=1)``. It prints the eps difference.

    python scripts/probe_torch_downsample_padding.py [--seeds 3]

CPU only, a few seconds; nothing on the main path calls it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pnpinversion_tpu_torch.configs import TINY  # noqa: E402
from pnpinversion_tpu_torch.convert.safetensors_io import write_safetensors  # noqa: E402
from pnpinversion_tpu_torch.pipeline import SDPipeline  # noqa: E402


def _export(pipe: SDPipeline, root: str) -> None:
    for module, sub in ((pipe.unet, "unet"), (pipe.vae, "vae"), (pipe.text_encoder,
                                                                 "text_encoder")):
        os.makedirs(os.path.join(root, sub))
        write_safetensors(os.path.join(root, sub, "model.safetensors"), module.state_dict())


def _diffusers_padding(unet) -> int:
    """Every downsample conv of the UNet pads (1, 1), as diffusers'
    Downsample2D does; returns how many were switched."""
    n = 0
    for blk in unet.down_blocks:
        if hasattr(blk, "downsamplers"):
            conv = blk.downsamplers[0].conv
            conv.forward = lambda x, c=conv: F.conv2d(x, c.weight.to(x.dtype),
                                                      c.bias.to(x.dtype), stride=2, padding=1)
            n += 1
    return n


@torch.inference_mode()
def probe(seed: int) -> dict:
    with tempfile.TemporaryDirectory() as root:
        _export(SDPipeline.create(TINY, seed=seed, device="cpu"), root)
        pipe = SDPipeline.create(TINY, checkpoint_dir=root, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    lat = TINY.latent_size
    x = torch.randn((1, lat, lat, TINY.unet.in_channels), generator=gen)
    ctx = torch.randn((1, 77, TINY.unet.context_dim), generator=gen) * 0.5
    same, _ = pipe.unet(x, 500, ctx)
    switched = _diffusers_padding(pipe.unet)
    diffusers, _ = pipe.unet(x, 500, ctx)
    diff = (diffusers - same).abs()
    return {"seed": seed, "downsamplers": switched, "eps_max_abs": same.abs().max().item(),
            "max_abs_diff": diff.max().item(), "mean_abs_diff": diff.mean().item(),
            "max_diff_rel_to_max": (diff.max() / same.abs().max()).item()}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args(argv)
    rows = [probe(seed) for seed in range(args.seeds)]
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
