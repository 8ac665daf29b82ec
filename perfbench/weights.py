"""Seeded weights for a configuration, made on the device by the benchmark and
handed to the program and to the reference alike.

Every parameter the reference networks name is drawn from one
``torch.Generator`` on the device in two large calls (one uniform draw for all
products and norms, one normal draw for the embeddings), in the dtype the
program serves them in, then scaled leaf by leaf in place: products' weights
and biases uniform(±1/sqrt(fan_in)) (PyTorch's default), norm scales
1 ± 0.1 and shifts ±0.1, token embeddings N(0, 0.02²), position embeddings
N(0, 0.01²). The same seed gives the same weights.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from perfbench.reference import models as R


def _leaves(config: dict):
    """(part, name, shape, kind, scale) of every parameter, in a fixed order."""
    out = []
    for part, model in R.build(config, "meta").items():
        for mod_name, mod in model.named_modules():
            prefix = f"{mod_name}." if mod_name else ""
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                bound = mod.weight[0].numel() ** -0.5
                out.append((part, prefix + "weight", mod.weight.shape, "uniform", bound))
                if mod.bias is not None:
                    out.append((part, prefix + "bias", mod.bias.shape, "uniform", bound))
            elif isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
                out.append((part, prefix + "weight", mod.weight.shape, "scale", 0.1))
                out.append((part, prefix + "bias", mod.bias.shape, "uniform", 0.1))
            elif isinstance(mod, nn.Embedding):
                std = 0.01 if "position" in mod_name else 0.02
                out.append((part, prefix + "weight", mod.weight.shape, "normal", std))
    return out


@torch.no_grad()
def make(config: dict, seed: int, dtype: torch.dtype, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"unet", "vae", "text"} state dicts (views of two flat buffers)."""
    leaves = _leaves(config)
    sizes = {"u": 0, "n": 0}
    for _, _, shape, kind, _ in leaves:
        sizes["n" if kind == "normal" else "u"] += shape.numel()
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = {"u": torch.empty(sizes["u"], dtype=dtype, device=device).uniform_(-1, 1, generator=gen),
            "n": torch.empty(sizes["n"], dtype=dtype, device=device).normal_(generator=gen)}
    offsets = {"u": 0, "n": 0}
    out = {"unet": {}, "vae": {}, "text": {}}
    for part, name, shape, kind, scale in leaves:
        key = "n" if kind == "normal" else "u"
        view = flat[key][offsets[key]: offsets[key] + shape.numel()].view(shape)
        offsets[key] += shape.numel()
        view.mul_(scale)
        if kind == "scale":
            view.add_(1.0)
        out[part][name] = view
    return out
