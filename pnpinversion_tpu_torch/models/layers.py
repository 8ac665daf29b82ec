"""Functional NN layers and the small modules that hold their parameters.

Activations inside the models are logical NCHW tensors kept in the
channels_last memory format, so the NHWC views the JAX package computes on
(``x.permute(0, 2, 3, 1)``) cost no copy. Parameters use the diffusers /
transformers names and layouts (Linear (out, in), Conv2d OIHW), so the
JAX package's weights and real checkpoints load by key.

Numerics follow ``pnpinversion_tpu/models/layers.py``: Linear and Conv2d cast
their parameters to the dtype of the activation they meet, so f32 activations
run a bf16 model in f32 on its bf16-valued weights; GroupNorm takes one-pass
moments E[x^2] - E[x]^2 in f32; LayerNorm is one-pass for bf16 and two-pass
for f32; a stride-2 "SAME" conv pads (0 before, 1 after) as XLA does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """x (B, C, H, W); ``padding`` is "SAME" (XLA's split: the odd pixel goes
    after) or "VALID"."""
    weight = weight.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    pad = (0, 0)
    if padding == "SAME":
        ph = _same_pads(x.shape[2], weight.shape[2], stride)
        pw = _same_pads(x.shape[3], weight.shape[3], stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return F.conv2d(x, weight, bias, stride=stride, padding=pad)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of x (B, C, H, W) with one-pass f32 moments, applied as one
    per-channel affine y = x*a + b."""
    b, c, h, w = x.shape
    xf = x.permute(0, 2, 3, 1).float().reshape(b, h * w, groups, c // groups)
    n = h * w * (c // groups)
    mean = xf.sum(dim=(1, 3)) / n
    var = torch.clamp((xf * xf).sum(dim=(1, 3)) / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    scale = weight.float().view(groups, c // groups)
    a = inv[:, :, None] * scale
    shift = bias.float().view(groups, c // groups) - (mean * inv)[:, :, None] * scale
    y = xf * a[:, None] + shift[:, None]
    return y.reshape(b, h, w, c).to(x.dtype).permute(0, 3, 1, 2)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim in f32: one-pass moments for bf16 inputs,
    two-pass for f32 (the JAX package's rule)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    if x.dtype == torch.bfloat16:
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    else:
        dev = xf - mean
        var = (dev * dev).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True, downscale_freq_shift: float = 0.0,
                       dtype=torch.float32) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers ``Timesteps``), computed in f32
    and then cast."""
    t = torch.atleast_1d(t).float()
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = t[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb.to(dtype)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


# ---------------------------------------------------------------------------
# parameter holders (diffusers names) whose forward is the functional layer
# ---------------------------------------------------------------------------

class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype (the parameters cast to it)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class Conv2d(nn.Conv2d):
    """nn.Conv2d's parameters with XLA's "SAME"/"VALID" padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: str = "SAME", bias: bool = True):
        super().__init__(in_ch, out_ch, kernel, stride=stride, bias=bias)
        self.pad_mode = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.stride[0], self.pad_mode)


class GroupNorm(nn.GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's random init, drawn from ``generator``: Linear/Conv
    weights uniform(+-1/sqrt(fan_in)), biases 0, norm scales 1 and shifts 0,
    embeddings N(0, std) with the std each embedding module carries."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, m.init_std, generator=generator)
    return module
