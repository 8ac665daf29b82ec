"""SD-style UNet2DConditionModel with an explicit attention-control dispatch
(port of ``pnpinversion_tpu/models/unet.py``).

Parameters carry diffusers' names. ``UNet.forward`` takes and returns NHWC
latents, like the JAX ``unet_apply``; inside, activations are NCHW in the
channels_last memory format. Every attention call goes through
``controlled_attention`` with a static ``AttnSite`` from ``enumerate_sites``,
whose ``place_index``/``lb_slot`` order LocalBlend depends on.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pnpinversion_tpu_torch.configs import UNetConfig
from pnpinversion_tpu_torch.control.base import NO_CONTROL, AttnSite, BaseControl
from pnpinversion_tpu_torch.models.layers import (
    Conv2d,
    GroupNorm,
    LayerNorm,
    Linear,
    nearest_upsample_2x,
    silu,
    timestep_embedding,
)
from pnpinversion_tpu_torch.ops.attention import controlled_attention
from pnpinversion_tpu_torch.utils.observability import NULL, count, host_sync, span, tracing


def enumerate_sites(config: UNetConfig) -> List[Tuple[AttnSite, AttnSite]]:
    """(self_site, cross_site) per transformer block, in execution order."""
    n = len(config.block_out_channels)
    sites: List[Tuple[AttnSite, AttnSite]] = []
    index = 0
    store_counts: Dict[Tuple[str, bool], int] = {}
    # LocalBlend slots: coarsest cross-attn down block + coarsest cross-attn up block
    down_attn_res = [config.sample_size // (2**i) for i in range(n) if config.cross_attention[i]]
    lb_res = min(down_attn_res) if down_attn_res else -1
    lb_counter = 0

    def mk(place: str, res: int, channels: int) -> Tuple[AttnSite, AttnSite]:
        nonlocal index, lb_counter
        pair = []
        for is_cross in (False, True):
            key = (place, is_cross)
            if res * res <= 32 * 32:
                pidx = store_counts.get(key, 0)
                store_counts[key] = pidx + 1
            else:
                pidx = -1
            lb_slot = -1
            if is_cross and res == lb_res and place in ("down", "up"):
                lb_slot = lb_counter
                lb_counter += 1
            pair.append(AttnSite(index=index, place=place, resolution=res, is_cross=is_cross,
                                 heads=config.heads_at(channels), place_index=pidx,
                                 lb_slot=lb_slot))
        index += 1
        return pair[0], pair[1]

    for i in range(n):
        if config.cross_attention[i]:
            res = config.sample_size // (2**i)
            for _ in range(config.layers_per_block):
                sites.append(mk("down", res, config.block_out_channels[i]))
    sites.append(mk("mid", config.sample_size // (2 ** (n - 1)), config.block_out_channels[-1]))
    for i in range(n):
        j = n - 1 - i
        if config.cross_attention[j]:
            res = config.sample_size // (2**j)
            for _ in range(config.layers_per_block + 1):
                sites.append(mk("up", res, config.block_out_channels[j]))
    return sites


def num_lb_slots(config: UNetConfig) -> int:
    return sum(1 for pair in enumerate_sites(config) for s in pair if s.lb_slot >= 0)


def lb_resolution(config: UNetConfig) -> int:
    for pair in enumerate_sites(config):
        for s in pair:
            if s.lb_slot >= 0:
                return s.resolution
    return -1


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_dim: Optional[int], groups: int,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = Conv2d(in_ch, out_ch, 3)
        if temb_dim is not None:
            self.time_emb_proj = Linear(temb_dim, out_ch)
        self.norm2 = GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = Conv2d(out_ch, out_ch, 3)
        if in_ch != out_ch:
            self.conv_shortcut = Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                hook=None) -> torch.Tensor:
        h = self.conv1(silu(self.norm1(x)))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(silu(temb))[:, :, None, None]
        h = self.conv2(silu(self.norm2(h)))
        if hook is not None:
            h = hook(h)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, query_dim: int, context_dim: Optional[int] = None):
        super().__init__()
        kv_dim = context_dim if context_dim is not None else query_dim
        self.to_q = Linear(query_dim, query_dim, bias=False)
        self.to_k = Linear(kv_dim, query_dim, bias=False)
        self.to_v = Linear(kv_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([Linear(query_dim, query_dim)])


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact (erf) GELU


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(), Linear(dim * 4, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)


class Transformer2D(nn.Module):
    def __init__(self, dim: int, context_dim: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(groups, dim, eps=1e-6)
        self.proj_in = Conv2d(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(dim, context_dim)])
        self.proj_out = Conv2d(dim, dim, 1)

    def forward(self, x, context, sites: Tuple[AttnSite, AttnSite], control: BaseControl,
                tensors, state, step):
        b, c, h, w = x.shape
        hs = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        self_site, cross_site = sites
        for blk in self.transformer_blocks:
            out, state = controlled_attention(blk.attn1, blk.norm1(hs), None, self_site,
                                              control, tensors, state, step)
            hs = hs + out
            out, state = controlled_attention(blk.attn2, blk.norm2(hs), context, cross_site,
                                              control, tensors, state, step)
            hs = hs + out
            hs = hs + blk.ff(blk.norm3(hs))
        hs = hs.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(hs) + x, state


class Resample(nn.Module):
    """Holds the ``conv`` of a diffusers Downsample2D/Upsample2D."""

    def __init__(self, ch: int, stride: int, padding: str = "SAME"):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=stride, padding=padding)


class Block(nn.Module):
    """A down/mid/up block's resnets and attentions (diffusers names)."""

    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class UNet(nn.Module):
    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        self.config = config
        self.sites = enumerate_sites(config)
        chs = config.block_out_channels
        temb_dim = config.time_embed_dim
        groups = config.norm_groups
        n = len(chs)

        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = Linear(chs[0], temb_dim)
        self.time_embedding.linear_2 = Linear(temb_dim, temb_dim)
        self.conv_in = Conv2d(config.in_channels, chs[0], 3)

        self.down_blocks = nn.ModuleList()
        out_ch = chs[0]
        for i in range(n):
            in_ch, out_ch = out_ch, chs[i]
            blk = Block()
            for j in range(config.layers_per_block):
                blk.resnets.append(ResnetBlock(in_ch if j == 0 else out_ch, out_ch, temb_dim,
                                               groups))
                if config.cross_attention[i]:
                    blk.attentions.append(Transformer2D(out_ch, config.context_dim, groups))
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([Resample(out_ch, 2)])
            self.down_blocks.append(blk)

        self.mid_block = Block()
        self.mid_block.resnets.append(ResnetBlock(chs[-1], chs[-1], temb_dim, groups))
        self.mid_block.attentions.append(Transformer2D(chs[-1], config.context_dim, groups))
        self.mid_block.resnets.append(ResnetBlock(chs[-1], chs[-1], temb_dim, groups))

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(chs))
        prev_out = rev[0]
        for i in range(n):
            out_ch_u = rev[i]
            in_ch_u = rev[min(i + 1, n - 1)]
            blk = Block()
            for j in range(config.layers_per_block + 1):
                skip_ch = in_ch_u if j == config.layers_per_block else out_ch_u
                res_in = prev_out if j == 0 else out_ch_u
                blk.resnets.append(ResnetBlock(res_in + skip_ch, out_ch_u, temb_dim, groups))
                if config.cross_attention[n - 1 - i]:
                    blk.attentions.append(Transformer2D(out_ch_u, config.context_dim, groups))
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Resample(out_ch_u, 1)])
            self.up_blocks.append(blk)
            prev_out = out_ch_u

        self.conv_norm_out = GroupNorm(groups, chs[0])
        self.conv_out = Conv2d(chs[0], config.out_channels, 3)

    def forward(self, x: torch.Tensor, t, context: torch.Tensor,
                control: BaseControl = NO_CONTROL, tensors=None, state=None,
                step: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
        """Noise prediction eps(x_t, t, context). x: (B, H, W, C_in) NHWC; t:
        one timestep for every row (a number), or a (B,) tensor of one per row
        (training); returns (eps NHWC, control state). Traced as
        ``pnpi.unet.call`` (``utils/observability.py``)."""
        traced = tracing()  # checked once: while off, no span and no count is built
        with span("pnpi.unet.call", rows=x.shape[0], step=step) if traced else NULL:
            if traced:
                count("pnpi.unet.calls")
                count("pnpi.unet.rows", x.shape[0])
            cfg = self.config
            state = {} if state is None else state
            site_iter = iter(self.sites)

            if not isinstance(t, torch.Tensor):
                host_sync("timestep", x.device)  # a blocking copy from pageable memory
                t = torch.tensor([t], dtype=torch.float32, device=x.device)
            temb = timestep_embedding(t, cfg.block_out_channels[0],
                                      flip_sin_to_cos=cfg.flip_sin_to_cos,
                                      downscale_freq_shift=cfg.freq_shift, dtype=x.dtype)
            temb = temb.expand(x.shape[0], -1)
            temb = self.time_embedding.linear_2(silu(self.time_embedding.linear_1(temb)))

            h = self.conv_in(x.permute(0, 3, 1, 2))
            residuals = [h]
            for i, blk in enumerate(self.down_blocks):
                for j, rn in enumerate(blk.resnets):
                    h = rn(h, temb)
                    if cfg.cross_attention[i]:
                        h, state = blk.attentions[j](h, context, next(site_iter), control, tensors,
                                                     state, step)
                    residuals.append(h)
                if hasattr(blk, "downsamplers"):
                    h = blk.downsamplers[0].conv(h)
                    residuals.append(h)

            mid = self.mid_block
            h = mid.resnets[0](h, temb)
            h, state = mid.attentions[0](h, context, next(site_iter), control, tensors, state, step)
            h = mid.resnets[1](h, temb)

            n = len(cfg.block_out_channels)
            for i, blk in enumerate(self.up_blocks):
                for j, rn in enumerate(blk.resnets):
                    h = torch.cat([h, residuals.pop()], dim=1)
                    key = f"up_{i}_resnet_{j}"
                    h = rn(h, temb, hook=lambda hh, key=key: control.resnet_hook(
                        key, hh, tensors, state, step))
                    if cfg.cross_attention[n - 1 - i]:
                        h, state = blk.attentions[j](h, context, next(site_iter), control, tensors,
                                                     state, step)
                if hasattr(blk, "upsamplers"):
                    h = blk.upsamplers[0].conv(nearest_upsample_2x(h))

            h = self.conv_out(silu(self.conv_norm_out(h)))
            return h.permute(0, 2, 3, 1), state


def apply_images(unet: UNet, x: torch.Tensor, t: int, context: torch.Tensor,
                 control: BaseControl = NO_CONTROL, tensors=None, state=None,
                 step: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """The UNet on N images' rows at once: x (N, R, h, w, c) and context
    (N, R, 77, D) go in as one batch of N*R rows, image-major (the layout a
    control's hooks expect); returns (eps (N, R, h, w, out_channels), control
    state)."""
    eps, state = unet(x.reshape((-1,) + x.shape[2:]), t,
                      context.reshape((-1,) + context.shape[2:]), control, tensors, state, step)
    return eps.reshape(x.shape[:-1] + eps.shape[-1:]), state
