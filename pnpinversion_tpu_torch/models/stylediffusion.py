"""StyleDiffusion's mapping networks (port of
``pnpinversion_tpu/models/stylediffusion.py``).

Per DDIM step one network maps the CLIP ViT-B/16 image tokens (197, 768) to
a (154, 768) tensor whose halves scale and shift the text context of the V
projection: ``context * emb[:77] + emb[77:]``. A network is conv_start
(Conv1d 197 -> 154, kernel 1), BLOCK_NUM blocks of [Conv1d 154 -> 154,
BatchNorm1d with batch statistics, LeakyReLU 0.01] and conv_end; a Conv1d
with kernel 1 is a matmul over the token axis.

Parameters are a flat dict of tensors (``conv_start.kernel``,
``blocks.0.bn_scale``, ...). Every tensor has a leading image axis N: each
image trains its own networks. A whole edit's networks stack the T steps
after it, (N, T, ...); ``mapper_at_step`` picks one step's. Each image's
tokens are a batch of one, as in every JAX caller, so the batch statistics
of an image are over its own (154, 768) values per channel and never mix
images.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

MAX_WORDS = 77
SCALE = 2  # emb rows = 77 * SCALE

Params = Dict[str, torch.Tensor]


def init_mapper_params(generator: torch.Generator, images: int, num_steps: int,
                       tokens_in: int = 197, block_num: int = 1) -> Params:
    """Random networks (N, T, ...) from ``generator``, the JAX package's
    init: kernels uniform(+-1/sqrt(fan_in)), zero biases, norm scale 1 and
    shift 0."""
    out = MAX_WORDS * SCALE
    dev = generator.device

    def conv(name, cin, cout):
        s = (1.0 / cin) ** 0.5
        k = torch.empty((images, num_steps, cout, cin), device=dev).uniform_(
            -s, s, generator=generator)
        return {f"{name}.kernel": k, f"{name}.bias": torch.zeros((images, num_steps, cout),
                                                                   device=dev)}

    p = {**conv("conv_start", tokens_in, out), **conv("conv_end", out, out)}
    for b in range(block_num):
        p.update(conv(f"blocks.{b}.conv", out, out))
        p[f"blocks.{b}.bn_scale"] = torch.ones((images, num_steps, out), device=dev)
        p[f"blocks.{b}.bn_bias"] = torch.zeros((images, num_steps, out), device=dev)
    return p


def mapper_at_step(params: Params, step: int) -> Params:
    """One step's networks (N, ...) from the stacked (N, T, ...)."""
    return {k: v[:, step] for k, v in params.items()}


def num_blocks(params: Params) -> int:
    return sum(1 for k in params if k.endswith(".bn_scale"))


def _conv1d(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """x (N, Cin, D); kernel (N, Cout, Cin)."""
    return torch.einsum("noi,nid->nod", p[f"{name}.kernel"], x) + p[f"{name}.bias"][:, :, None]


def _batchnorm1d(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """Train-mode BatchNorm1d of each image's batch of one: statistics over
    D per (image, channel)."""
    mean = x.mean(dim=2, keepdim=True)
    var = x.var(dim=2, keepdim=True, unbiased=False)
    xn = (x - mean) * torch.rsqrt(var + eps)
    return xn * scale[:, :, None] + bias[:, :, None]


def mapper_apply(step_params: Params, img_tokens: torch.Tensor) -> torch.Tensor:
    """img_tokens (N, 197, width), each image's own tokens -> (N, 154,
    width) through each image's own network."""
    h = _conv1d(step_params, "conv_start", img_tokens)
    for b in range(num_blocks(step_params)):
        h = _conv1d(step_params, f"blocks.{b}.conv", h)
        h = _batchnorm1d(step_params[f"blocks.{b}.bn_scale"], step_params[f"blocks.{b}.bn_bias"],
                         h)
        h = F.leaky_relu(h, negative_slope=0.01)
    return _conv1d(step_params, "conv_end", h)


def forward_embed(step_params: Params, context: torch.Tensor,
                  img_tokens: torch.Tensor) -> torch.Tensor:
    """context (N, R, 77, width), R rows of each image -> the mapped V
    context (N, R, 77, width), in the promoted dtype (f32 for a bf16 context
    and f32 networks, as in the JAX package)."""
    emb = mapper_apply(step_params, img_tokens)[:, None]
    return context * emb[:, :, :MAX_WORDS] + emb[:, :, MAX_WORDS:]
