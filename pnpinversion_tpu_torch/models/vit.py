"""Vision Transformers of the evaluator (port of
``pnpinversion_tpu/models/vit.py``):

- the CLIP ViT-L/14 vision tower with its projection, for CLIPScore;
- DINO ViT-B/8, for the structure distance, which reads the last layer's
  keys, so the forward can return every layer's qkv output.

Parameters keep the JAX tree's names (a fused ``qkv`` Linear per layer).
Attention is plain f32 softmax: the sequences (257 for CLIP L/14, 785 for
DINO B/8 at 224^2) are below the flash kernel's 1024, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pnpinversion_tpu_torch.evaluation.metrics import resize
from pnpinversion_tpu_torch.models.layers import Conv2d, LayerNorm, init_random_, quick_gelu


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    # CLIP: pre/post layernorm + projection; DINO: a final norm, no projection
    style: str = "clip"  # 'clip' | 'dino'
    projection_dim: int = 768
    activation: str = "quick_gelu"  # DINO uses exact gelu

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


CLIP_VIT_L14 = ViTConfig()
DINO_VITB8 = ViTConfig(patch_size=8, width=768, layers=12, heads=12, style="dino",
                       activation="gelu")
TINY_VIT = ViTConfig(image_size=32, patch_size=8, width=32, layers=2, heads=2,
                     projection_dim=16)


class ViTLayer(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.ln1 = LayerNorm(width)
        self.qkv = nn.Linear(width, 3 * width)
        self.out_proj = nn.Linear(width, width)
        self.ln2 = LayerNorm(width)
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)


def _interp_pos_embed(pos: torch.Tensor, n_patches: int, width: int) -> torch.Tensor:
    """DINO's bicubic interpolation of the position embeddings when the input
    has another number of patches than the table (the JAX resize)."""
    n_trained = pos.shape[1] - 1
    if n_trained == n_patches:
        return pos
    side_t, side = int(n_trained ** 0.5), int(n_patches ** 0.5)
    grid = resize(pos[0, 1:].reshape(side_t, side_t, width), (side, side), "bicubic")
    return torch.cat([pos[:, :1], grid.reshape(1, side * side, width).to(pos.dtype)], dim=1)


class ViT(nn.Module):
    def __init__(self, config: ViTConfig = CLIP_VIT_L14):
        super().__init__()
        self.config = config
        w = config.width
        # CLIP's patch convolution has no bias, DINO's has one
        self.patch_embed = Conv2d(3, w, config.patch_size, stride=config.patch_size,
                                  padding="VALID", bias=config.style == "dino")
        self.cls_token = nn.Parameter(torch.empty(1, 1, w))
        self.pos_embed = nn.Parameter(torch.empty(1, config.num_patches + 1, w))
        if config.style == "clip":
            self.pre_layernorm = LayerNorm(w)
            self.post_layernorm = LayerNorm(w)
            self.projection = nn.Linear(w, config.projection_dim, bias=False)
        else:
            self.norm = LayerNorm(w)
        self.layers = nn.ModuleList([ViTLayer(w) for _ in range(config.layers)])

    def forward(self, image: torch.Tensor, return_qkv: bool = False,
                return_tokens: bool = False) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """image (B, H, W, 3), normalised -> (pooled, the per-layer qkv
        outputs (B, N + 1, 3 width) if ``return_qkv``).

        CLIP: pooled = projection(post_ln(class token)); with
        ``return_tokens`` post_ln of all tokens (B, N + 1, width) instead.
        DINO: pooled = norm(class token); with ``return_tokens`` norm of all
        tokens."""
        cfg = self.config
        b = image.shape[0]
        patches = self.patch_embed(image.permute(0, 3, 1, 2))
        x = patches.flatten(2).transpose(1, 2)
        n = x.shape[1]
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        x = x + _interp_pos_embed(self.pos_embed, n, cfg.width).to(x.dtype)
        if cfg.style == "clip":
            x = self.pre_layernorm(x)
        heads, hd = cfg.heads, cfg.width // cfg.heads
        act = quick_gelu if cfg.activation == "quick_gelu" else F.gelu
        qkvs: List[torch.Tensor] = []
        for lp in self.layers:
            qkv = lp.qkv(lp.ln1(x))
            if return_qkv:
                qkvs.append(qkv)
            q, k, v = (t.reshape(b, -1, heads, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
            scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            attn = torch.matmul(probs, v).transpose(1, 2).reshape(b, -1, cfg.width)
            x = x + lp.out_proj(attn)
            x = x + lp.fc2(act(lp.fc1(lp.ln2(x))))
        if cfg.style == "clip":
            if return_tokens:
                return self.post_layernorm(x), qkvs
            return self.projection(self.post_layernorm(x[:, 0])), qkvs
        if return_tokens:
            return self.norm(x), qkvs
        return self.norm(x)[:, 0], qkvs


def init_vit_(model: ViT, generator: torch.Generator) -> ViT:
    """The JAX package's init, drawn from ``generator``: Linear weights
    uniform(+-1/sqrt(fan_in)) with zero biases, norms 1 and 0, and the patch
    embedding, class token and position table N(0, 0.02)."""
    init_random_(model, generator)
    with torch.no_grad():
        for p in (model.patch_embed.weight, model.cls_token, model.pos_embed):
            p.normal_(0.0, 0.02, generator=generator)
    return model


def dino_keys_self_sim(model: ViT, image: torch.Tensor, layer: int = 11) -> torch.Tensor:
    """Cosine self-similarity (N + 1, N + 1) of layer ``layer``'s keys, heads
    concatenated; the norms' product floored at 1e-8. image (1, H, W, 3)."""
    _, qkvs = model(image, return_qkv=True)
    w = model.config.width
    # qkv is [q | k | v], each heads x head_dim: the keys with heads
    # concatenated are its middle third
    keys = qkvs[layer][0, :, w : 2 * w]
    norm = torch.linalg.norm(keys, dim=1, keepdim=True)
    return (keys @ keys.T) / torch.clamp(norm @ norm.T, min=1e-8)


def structure_distance(model: ViT, img_gt: torch.Tensor, img_pred: torch.Tensor,
                       layer: int = 11) -> torch.Tensor:
    """MSE between the two images' key self-similarity matrices. Inputs (1,
    224, 224, 3), already ImageNet-normalised (at the reference's 0..255
    scale)."""
    a = dino_keys_self_sim(model, img_gt, layer)
    b = dino_keys_self_sim(model, img_pred, layer)
    return torch.mean((a - b) ** 2)


def structure_distances(model: ViT, img_gt: torch.Tensor, img_pred: torch.Tensor,
                        layer: int = 11) -> torch.Tensor:
    """``structure_distance`` of each pair of a batch, (B,): inputs (B, 224,
    224, 3), both batches through one forward."""
    _, qkvs = model(torch.cat([img_gt, img_pred]), return_qkv=True)
    w = model.config.width
    keys = qkvs[layer][:, :, w : 2 * w]
    norm = torch.linalg.norm(keys, dim=2, keepdim=True)
    sim = (keys @ keys.transpose(1, 2)) / torch.clamp(norm @ norm.transpose(1, 2), min=1e-8)
    a, b = sim.chunk(2)
    return torch.mean((a - b) ** 2, dim=(1, 2))
