"""Stable Diffusion's three networks in plain PyTorch, for the benchmark's
check: the UNet (UNet2DConditionModel), the VAE (AutoencoderKL) and the CLIP
text tower (CLIPTextModel), with the diffusers / transformers parameter names,
so one state dict loads here and into the program under test.

Everything computes in float32 on NCHW tensors with plain operations: no fused
attention, no custom kernel, no cache. The precision of the products is set by
``set_precision``: "f32" (TF32 off, the reference), "tf32" (TF32 on) or "fp8"
(every operand of a product rounded to float8 e4m3 with one scale per tensor,
the products then taken in f32); in both the sampler's latents are kept at
that precision between steps (``store``). The last two are the controls: the
reference computed one precision below what a configuration states.

Departures from diffusers, all shared with the program's own definition of the
method: a stride-2 UNet downsample pads (0, 1) as XLA's "SAME" does (diffusers
pads (1, 1)); timesteps and schedules as ``diffusion.py`` says.

Attention calls go through ``attend(site, q, k, v, scale)`` of an optional
controller, which returns the attention output or None for the plain path;
the UNet's transformer blocks carry their ``Site`` (place, resolution, cross
or self, heads) in execution order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

PRECISION = {"mode": "f32"}
FP8_MAX = 448.0


def set_precision(mode: str) -> None:
    """"f32" (TF32 off), "tf32" or "fp8"; TF32 is a process-wide switch."""
    if mode not in ("f32", "tf32", "fp8"):
        raise ValueError(f"unknown precision {mode!r}")
    PRECISION["mode"] = mode
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _q(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale (fp8 mode only)."""
    if PRECISION["mode"] != "fp8":
        return x
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def store(x: torch.Tensor) -> torch.Tensor:
    """A tensor the sampler keeps from one step to the next, held at the
    precision's storage: e4m3 under a per-tensor scale (fp8), a 10-bit
    mantissa (tf32, rounded to nearest), unchanged (f32)."""
    mode = PRECISION["mode"]
    if mode == "fp8":
        return _q(x)
    if mode == "tf32":
        bits = x.float().contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)
    return x


def linear(x, weight, bias=None):
    return F.linear(_q(x), _q(weight), bias)


def matmul(a, b):
    return torch.matmul(_q(a), _q(b))


def conv(x, weight, bias=None, stride=1, pad=(1, 1, 1, 1)):
    """pad: (left, right, top, bottom), applied explicitly."""
    if any(pad):
        x = F.pad(x, pad)
    return F.conv2d(_q(x), _q(weight), bias, stride=stride)


class Linear(nn.Linear):
    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Conv(nn.Conv2d):
    def __init__(self, cin, cout, k, stride=1, pad=None):
        super().__init__(cin, cout, k, stride=stride)
        self.pads = pad if pad is not None else ((k // 2,) * 4)

    def forward(self, x):
        return conv(x, self.weight, self.bias, self.stride[0], self.pads)


def group_norm(norm: nn.GroupNorm, x):
    return F.group_norm(x, norm.num_groups, norm.weight, norm.bias, norm.eps)


def silu(x):
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Site:
    place: str  # down | mid | up
    resolution: int
    cross: bool
    heads: int
    lb_slot: int  # LocalBlend slot (cross-attention at the LocalBlend resolution), or -1


class Resnet(nn.Module):
    def __init__(self, cin, cout, temb, groups, eps=1e-5):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = Conv(cin, cout, 3)
        if temb:
            self.time_emb_proj = Linear(temb, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = Conv(cout, cout, 3)
        if cin != cout:
            self.conv_shortcut = Conv(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(silu(group_norm(self.norm1, x)))
        if temb is not None:
            h = h + self.time_emb_proj(silu(temb))[:, :, None, None]
        h = self.conv2(silu(group_norm(self.norm2, h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, dim, kv_dim, bias):
        super().__init__()
        self.to_q = Linear(dim, dim, bias=bias)
        self.to_k = Linear(kv_dim, dim, bias=bias)
        self.to_v = Linear(kv_dim, dim, bias=bias)
        self.to_out = nn.ModuleList([Linear(dim, dim)])


def plain_attention(q, k, v, scale):
    """q, k, v (B, H, S, d) -> (B, H, Sq, d), softmax in f32."""
    return matmul(torch.softmax(matmul(q, k.transpose(-1, -2)) * scale, dim=-1), v)


def attention_probs(q, k, scale):
    return torch.softmax(matmul(q, k.transpose(-1, -2)) * scale, dim=-1)


class FF(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([nn.Module(), nn.Identity(), Linear(4 * dim, dim)])
        self.net[0].proj = Linear(dim, 8 * dim)

    def forward(self, x):
        h, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](h * F.gelu(gate))


class TransformerBlock(nn.Module):
    def __init__(self, dim, ctx):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim) for _ in range(3))
        self.attn1 = Attention(dim, dim, False)
        self.attn2 = Attention(dim, ctx, False)
        self.ff = FF(dim)


class Transformer(nn.Module):
    def __init__(self, dim, ctx, groups):
        super().__init__()
        self.norm = nn.GroupNorm(groups, dim, eps=1e-6)
        self.proj_in = Conv(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(dim, ctx)])
        self.proj_out = Conv(dim, dim, 1)
        self.sites: tuple = ()

    def forward(self, x, context, control):
        b, c, h, w = x.shape
        hs = self.proj_in(group_norm(self.norm, x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        blk = self.transformer_blocks[0]
        for attn, norm, site in ((blk.attn1, blk.norm1, self.sites[0]),
                                 (blk.attn2, blk.norm2, self.sites[1])):
            y = F.layer_norm(hs, (c,), norm.weight, norm.bias, norm.eps)
            ctx = y if not site.cross else context
            heads = site.heads

            def split(t):
                return t.view(b, t.shape[1], heads, c // heads).transpose(1, 2)

            q, k, v = split(attn.to_q(y)), split(attn.to_k(ctx)), split(attn.to_v(ctx))
            scale = (c // heads) ** -0.5
            out = control.attend(site, q, k, v, scale) if control is not None else None
            if out is None:
                out = plain_attention(q, k, v, scale)
            hs = hs + attn.to_out[0](out.transpose(1, 2).reshape(b, h * w, c))
        hs = hs + blk.ff(F.layer_norm(hs, (c,), blk.norm3.weight, blk.norm3.bias, blk.norm3.eps))
        return self.proj_out(hs.reshape(b, h, w, c).permute(0, 3, 1, 2)) + x


class Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class Sampler(nn.Module):
    def __init__(self, ch, stride, pad):
        super().__init__()
        self.conv = Conv(ch, ch, 3, stride=stride, pad=pad)


def timestep_embedding(t: torch.Tensor, dim: int, flip: bool, shift: float) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / (half - shift))
    arg = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)
    return torch.cat([emb[:, half:], emb[:, :half]], dim=-1) if flip else emb


class UNet(nn.Module):
    """cfg: the configuration file's ``unet`` group (diffusers' keys)."""

    def __init__(self, cfg: dict):
        super().__init__()
        chs = cfg["block_out_channels"]
        n, L, groups = len(chs), cfg["layers_per_block"], cfg["norm_num_groups"]
        ctx = cfg["cross_attention_dim"]
        temb = chs[0] * 4
        cross = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
        # diffusers' attention_head_dim counts heads (one number, SD1.x, or one
        # per level, SD2.x), despite its name
        heads = cfg["attention_head_dim"]
        self.cfg = cfg
        self.heads = list(heads) if isinstance(heads, list) else [heads] * n
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = Linear(chs[0], temb)
        self.time_embedding.linear_2 = Linear(temb, temb)
        self.conv_in = Conv(cfg["in_channels"], chs[0], 3)
        down_pad = (0, 1, 0, 1)
        self.down_blocks = nn.ModuleList()
        prev = chs[0]
        for i, c in enumerate(chs):
            blk = Block()
            for j in range(L):
                blk.resnets.append(Resnet(prev if j == 0 else c, c, temb, groups))
                if cross[i]:
                    blk.attentions.append(Transformer(c, ctx, groups))
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([Sampler(c, 2, down_pad)])
            self.down_blocks.append(blk)
            prev = c
        self.mid_block = Block()
        self.mid_block.resnets.extend([Resnet(chs[-1], chs[-1], temb, groups) for _ in range(2)])
        self.mid_block.attentions.append(Transformer(chs[-1], ctx, groups))
        self.up_blocks = nn.ModuleList()
        rev = list(reversed(chs))
        prev = rev[0]
        for i, c in enumerate(rev):
            skip_in = rev[min(i + 1, n - 1)]
            blk = Block()
            for j in range(L + 1):
                skip = skip_in if j == L else c
                blk.resnets.append(Resnet((prev if j == 0 else c) + skip, c, temb, groups))
                if cross[n - 1 - i]:
                    blk.attentions.append(Transformer(c, ctx, groups))
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Sampler(c, 1, (1, 1, 1, 1))])
            self.up_blocks.append(blk)
            prev = c
        self.conv_norm_out = nn.GroupNorm(groups, chs[0])
        self.conv_out = Conv(chs[0], cfg["out_channels"], 3)
        self._assign_sites(cross)

    def _assign_sites(self, cross: List[bool]) -> None:
        chs, size = self.cfg["block_out_channels"], self.cfg["sample_size"]
        n = len(chs)
        lb_res = min(size >> i for i in range(n) if cross[i])
        slot = 0

        def mark(tr, place, i):
            nonlocal slot
            res = size >> i
            lb = slot if (place != "mid" and res == lb_res) else -1
            slot += lb >= 0
            tr.sites = (Site(place, res, False, self.heads[i], -1),
                        Site(place, res, True, self.heads[i], lb))

        for i, blk in enumerate(self.down_blocks):
            for tr in blk.attentions:
                mark(tr, "down", i)
        mark(self.mid_block.attentions[0], "mid", n - 1)
        for i, blk in enumerate(self.up_blocks):
            for tr in blk.attentions:
                mark(tr, "up", n - 1 - i)
        self.lb_slots, self.lb_res = slot, lb_res

    def forward(self, x, t: float, context, control=None):
        """x (B, 4, h, w) f32 NCHW; t one timestep for every row; context
        (B, 77, D). Returns eps (B, 4, h, w)."""
        cfg = self.cfg
        tt = torch.full((x.shape[0],), float(t), device=x.device)
        temb = timestep_embedding(tt, cfg["block_out_channels"][0], cfg["flip_sin_to_cos"],
                                  cfg["freq_shift"])
        temb = self.time_embedding.linear_2(silu(self.time_embedding.linear_1(temb)))
        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks:
            for j, rn in enumerate(blk.resnets):
                h = rn(h, temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, context, control)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(h)
                skips.append(h)
        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, context, control)
        h = self.mid_block.resnets[1](h, temb)
        for blk in self.up_blocks:
            for j, rn in enumerate(blk.resnets):
                h = rn(torch.cat([h, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, context, control)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2, mode="nearest"))
        return self.conv_out(silu(group_norm(self.conv_norm_out, h)))


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

class VAEAttention(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q, self.to_k, self.to_v = Linear(ch, ch), Linear(ch, ch), Linear(ch, ch)
        self.to_out = nn.ModuleList([Linear(ch, ch)])

    def forward(self, x):
        b, c, h, w = x.shape
        hs = group_norm(self.group_norm, x).permute(0, 2, 3, 1).reshape(b, 1, h * w, c)
        out = plain_attention(self.to_q(hs), self.to_k(hs), self.to_v(hs), c ** -0.5)
        return x + self.to_out[0](out[:, 0]).reshape(b, h, w, c).permute(0, 3, 1, 2)


class Mid(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(ch, ch, None, groups, 1e-6) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VAE(nn.Module):
    """cfg: the configuration file's ``vae`` group."""

    def __init__(self, cfg: dict):
        super().__init__()
        chs, L, g = cfg["block_out_channels"], cfg["layers_per_block"], cfg["norm_num_groups"]
        lat, n = cfg["latent_channels"], len(chs)
        self.scaling = cfg["scaling_factor"]
        enc = self.encoder = nn.Module()
        enc.conv_in = Conv(cfg["in_channels"], chs[0], 3)
        enc.down_blocks = nn.ModuleList()
        prev = chs[0]
        for i, c in enumerate(chs):
            blk = Block()
            for j in range(L):
                blk.resnets.append(Resnet(prev if j == 0 else c, c, None, g, 1e-6))
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([Sampler(c, 2, (0, 1, 0, 1))])
            enc.down_blocks.append(blk)
            prev = c
        enc.mid_block = Mid(chs[-1], g)
        enc.conv_norm_out = nn.GroupNorm(g, chs[-1], eps=1e-6)
        enc.conv_out = Conv(chs[-1], 2 * lat, 3)
        dec = self.decoder = nn.Module()
        dec.conv_in = Conv(lat, chs[-1], 3)
        dec.mid_block = Mid(chs[-1], g)
        dec.up_blocks = nn.ModuleList()
        rev = list(reversed(chs))
        prev = rev[0]
        for i, c in enumerate(rev):
            blk = Block()
            for j in range(L + 1):
                blk.resnets.append(Resnet(prev if j == 0 else c, c, None, g, 1e-6))
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Sampler(c, 1, (1, 1, 1, 1))])
            dec.up_blocks.append(blk)
            prev = c
        dec.conv_norm_out = nn.GroupNorm(g, chs[0], eps=1e-6)
        dec.conv_out = Conv(chs[0], cfg["out_channels"], 3)
        self.quant_conv = Conv(2 * lat, 2 * lat, 1)
        self.post_quant_conv = Conv(lat, lat, 1)

    def encode(self, image_u8: torch.Tensor) -> torch.Tensor:
        """uint8 (B, H, W, 3) -> the scaled posterior mean (B, 4, h, w)."""
        enc = self.encoder
        h = enc.conv_in(image_u8.permute(0, 3, 1, 2).float() / 127.5 - 1.0)
        for blk in enc.down_blocks:
            for rn in blk.resnets:
                h = rn(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(h)
        h = enc.conv_out(silu(group_norm(enc.conv_norm_out, enc.mid_block(h))))
        return self.quant_conv(h)[:, : h.shape[1] // 2] * self.scaling

    def decode_float(self, latents: torch.Tensor) -> torch.Tensor:
        """scaled latents (B, 4, h, w) -> the decoder's output (B, 3, H, W),
        before the clamp (about [-1, 1])."""
        dec = self.decoder
        h = dec.mid_block(dec.conv_in(self.post_quant_conv(latents / self.scaling)))
        for blk in dec.up_blocks:
            for rn in blk.resnets:
                h = rn(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2, mode="nearest"))
        return dec.conv_out(silu(group_norm(dec.conv_norm_out, h)))


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """A decoder output (B, 3, H, W) -> uint8 (B, H, W, 3), as SD's pipelines
    convert it: clamp((x + 1) / 2), times 255, truncated."""
    img = torch.clamp(img / 2 + 0.5, 0.0, 1.0)
    return (img * 255).to(torch.uint8).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# CLIP text tower
# ---------------------------------------------------------------------------

class TextModel(nn.Module):
    """cfg: the configuration file's ``text_encoder`` group (transformers' keys)."""

    def __init__(self, cfg: dict):
        super().__init__()
        w, n = cfg["hidden_size"], cfg["num_hidden_layers"]
        self.cfg = cfg
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], w)
        tm.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"], w)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList()
        for _ in range(n):
            layer = nn.Module()
            layer.layer_norm1, layer.layer_norm2 = nn.LayerNorm(w), nn.LayerNorm(w)
            layer.self_attn = nn.Module()
            for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                setattr(layer.self_attn, name, Linear(w, w))
            layer.mlp = nn.Module()
            layer.mlp.fc1 = Linear(w, cfg["intermediate_size"])
            layer.mlp.fc2 = Linear(cfg["intermediate_size"], w)
            tm.encoder.layers.append(layer)
        tm.final_layer_norm = nn.LayerNorm(w)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """ids (B, S) -> last hidden state (B, S, width), f32."""
        cfg, tm = self.cfg, self.text_model
        b, s = ids.shape
        w, heads = cfg["hidden_size"], cfg["num_attention_heads"]
        h = tm.embeddings.token_embedding.weight[ids].float()
        h = h + tm.embeddings.position_embedding.weight[:s].float()
        mask = torch.full((s, s), float("-inf"), device=h.device).triu(1)
        if cfg["hidden_act"] == "quick_gelu":
            def act(x):
                return x * torch.sigmoid(1.702 * x)
        else:
            act = F.gelu

        def split(x):
            return x.view(b, s, heads, w // heads).transpose(1, 2)

        for layer in tm.encoder.layers:
            x = F.layer_norm(h, (w,), layer.layer_norm1.weight, layer.layer_norm1.bias, 1e-5)
            a = layer.self_attn
            q, k, v = split(a.q_proj(x)), split(a.k_proj(x)), split(a.v_proj(x))
            probs = torch.softmax(matmul(q, k.transpose(-1, -2)) * (w // heads) ** -0.5 + mask,
                                  dim=-1)
            h = h + a.out_proj(matmul(probs, v).transpose(1, 2).reshape(b, s, w))
            x = F.layer_norm(h, (w,), layer.layer_norm2.weight, layer.layer_norm2.bias, 1e-5)
            h = h + layer.mlp.fc2(act(layer.mlp.fc1(x)))
        fl = tm.final_layer_norm
        return F.layer_norm(h, (w,), fl.weight, fl.bias, 1e-5)


def build(config: dict, device="cpu") -> dict:
    """{"unet", "vae", "text"} of the configuration, on ``device`` (``meta``
    for shapes only), parameters uninitialised."""
    with torch.device(device):
        return {"unet": UNet(config["unet"]), "vae": VAE(config["vae"]),
                "text": TextModel(config["text_encoder"])}
