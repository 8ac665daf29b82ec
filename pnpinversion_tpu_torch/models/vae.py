"""AutoencoderKL, the SD VAE (port of ``pnpinversion_tpu/models/vae.py``),
with diffusers' names. The editing path uses the posterior mean (scaled by
0.18215, or unscaled), or a posterior sample on given noise (pix2pix-zero),
and the decoder. Public functions take and return NHWC
tensors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pnpinversion_tpu_torch.configs import VAEConfig
from pnpinversion_tpu_torch.models.layers import (
    Conv2d,
    GroupNorm,
    Linear,
    nearest_upsample_2x,
    silu,
)
from pnpinversion_tpu_torch.models.unet import Block, Resample, ResnetBlock
from pnpinversion_tpu_torch.utils.observability import host_sync, span, spanned


class VAEAttention(nn.Module):
    """Mid-block single-head self-attention (plain: f32 scores and softmax)."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, eps=1e-6)
        self.to_q = Linear(ch, ch)
        self.to_k = Linear(ch, ch)
        self.to_v = Linear(ch, ch)
        self.to_out = nn.ModuleList([Linear(ch, ch)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hs = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(hs), self.to_k(hs), self.to_v(hs)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        probs = torch.softmax(scores * c ** -0.5, dim=-1).to(x.dtype)
        out = self.to_out[0](torch.matmul(probs, v))
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _Mid(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch, None, groups, eps=1e-6)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VAE(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        chs = config.block_out_channels
        g = config.norm_groups
        n = len(chs)
        lat = config.latent_channels

        enc = nn.Module()
        enc.conv_in = Conv2d(config.in_channels, chs[0], 3)
        enc.down_blocks = nn.ModuleList()
        out_ch = chs[0]
        for i in range(n):
            in_ch, out_ch = out_ch, chs[i]
            blk = Block()
            for j in range(config.layers_per_block):
                blk.resnets.append(ResnetBlock(in_ch if j == 0 else out_ch, out_ch, None, g,
                                               eps=1e-6))
            if i < n - 1:
                # VALID after an explicit (0, 1) pad, as diffusers' VAE does
                blk.downsamplers = nn.ModuleList([Resample(out_ch, 2, padding="VALID")])
            enc.down_blocks.append(blk)
        enc.mid_block = _Mid(chs[-1], g)
        enc.conv_norm_out = GroupNorm(g, chs[-1], eps=1e-6)
        enc.conv_out = Conv2d(chs[-1], 2 * lat, 3)
        self.encoder = enc

        dec = nn.Module()
        dec.conv_in = Conv2d(lat, chs[-1], 3)
        dec.mid_block = _Mid(chs[-1], g)
        dec.up_blocks = nn.ModuleList()
        rev = list(reversed(chs))
        prev = rev[0]
        for i in range(n):
            out_ch_u = rev[i]
            blk = Block()
            for j in range(config.layers_per_block + 1):
                blk.resnets.append(ResnetBlock(prev if j == 0 else out_ch_u, out_ch_u, None, g,
                                               eps=1e-6))
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Resample(out_ch_u, 1)])
            dec.up_blocks.append(blk)
            prev = out_ch_u
        dec.conv_norm_out = GroupNorm(g, chs[0], eps=1e-6)
        dec.conv_out = Conv2d(chs[0], config.in_channels, 3)
        self.decoder = dec

        self.quant_conv = Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = Conv2d(lat, lat, 1)

    def encode_moments(self, image: torch.Tensor) -> tuple:
        """image (B, H, W, 3) in [-1, 1] -> the posterior's (mean, logvar),
        each (B, h, w, 4) and unscaled, logvar clipped to [-30, 20]."""
        enc = self.encoder
        h = enc.conv_in(image.permute(0, 3, 1, 2))
        for blk in enc.down_blocks:
            for rn in blk.resnets:
                h = rn(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = enc.mid_block(h)
        h = enc.conv_out(silu(enc.conv_norm_out(h)))
        mean, logvar = self.quant_conv(h).permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, image: torch.Tensor, scale: bool = True,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """image (B, H, W, 3) in [-1, 1] -> the posterior mean (B, h, w, 4),
        or with ``noise`` (B, h, w, 4) the posterior sample
        mean + exp(logvar / 2) * noise; times the scaling factor unless
        ``scale`` is False (the unscaled mean is the instruction editors'
        image conditioning)."""
        z, logvar = self.encode_moments(image)
        if noise is not None:
            z = z + torch.exp(0.5 * logvar) * noise.to(z.dtype)
        return z * self.config.scaling_factor if scale else z

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """scaled latents (B, h, w, 4) -> image (B, H, W, 3) in [-1, 1]."""
        dec = self.decoder
        z = self.post_quant_conv((latents / self.config.scaling_factor).permute(0, 3, 1, 2))
        h = dec.mid_block(dec.conv_in(z))
        for blk in dec.up_blocks:
            for rn in blk.resnets:
                h = rn(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(nearest_upsample_2x(h))
        h = dec.conv_out(silu(dec.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1)


@spanned("pnpi.edit.vae_encode")
def image_to_latent(vae: VAE, image_uint8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 (B, H, W, 3) or (H, W, 3) -> scaled latent (B, h, w, 4)."""
    if image_uint8.dim() == 3:
        image_uint8 = image_uint8[None]
    return vae.encode(image_uint8.to(dtype) / 127.5 - 1.0)


@spanned("pnpi.edit.vae_decode")
def latent_to_image(vae: VAE, latents: torch.Tensor) -> torch.Tensor:
    """scaled latents -> uint8 (B, H, W, 3)."""
    img = torch.clamp(vae.decode(latents) / 2 + 0.5, 0.0, 1.0)
    return (img * 255).to(torch.uint8)


def to_host(images: torch.Tensor) -> np.ndarray:
    """Decoded panels (``latent_to_image``'s) as a host array: a copy the
    host waits for."""
    with span("pnpi.edit.to_host"):
        host_sync("panels", images.device)
        return images.cpu().numpy()
