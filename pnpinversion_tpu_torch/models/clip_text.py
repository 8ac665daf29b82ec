"""CLIP text encoder (port of ``pnpinversion_tpu/models/clip_text.py``):
the ViT-L/14 text tower of SD1.x with transformers' ``CLIPTextModel`` names.
Returns the final-layer hidden states in the dtype asked for, whatever the
weights' dtype: its projections cast their weights to the activation's
dtype, as the JAX package's ``linear`` does (so a bf16 pipeline's tower
computes in f32 when asked, as the JAX trainer's f32 steps have it).
Attention is plain (causal, f32 softmax): there is no kernel at this site.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pnpinversion_tpu_torch.configs import CLIPTextConfig
from pnpinversion_tpu_torch.models.layers import LayerNorm, Linear, quick_gelu


def _embedding(num: int, dim: int, init_std: float) -> nn.Embedding:
    emb = nn.Embedding(num, dim)
    emb.init_std = init_std  # read by layers.init_random_
    return emb


class CLIPAttention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.q_proj = Linear(width, width)
        self.k_proj = Linear(width, width)
        self.v_proj = Linear(width, width)
        self.out_proj = Linear(width, width)


class CLIPMLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1 = Linear(width, width * 4)
        self.fc2 = Linear(width * 4, width)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.layer_norm1 = LayerNorm(width)
        self.self_attn = CLIPAttention(width)
        self.layer_norm2 = LayerNorm(width)
        self.mlp = CLIPMLP(width)


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = config
        tm = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = _embedding(config.vocab_size, config.width, 0.02)
        tm.embeddings.position_embedding = _embedding(config.max_length, config.width, 0.01)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList(
            [CLIPEncoderLayer(config.width) for _ in range(config.layers)])
        tm.final_layer_norm = LayerNorm(config.width)
        self.text_model = tm

    def forward(self, input_ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """input_ids (B, S) -> last hidden state (B, S, width) in ``dtype``."""
        cfg = self.config
        tm = self.text_model
        b, s = input_ids.shape
        # out-of-vocabulary ids clamp, as a JAX gather does
        ids = input_ids.clamp(0, cfg.vocab_size - 1)
        h = tm.embeddings.token_embedding.weight[ids].to(dtype)
        h = h + tm.embeddings.position_embedding.weight[:s].to(dtype)

        heads = cfg.heads
        hd = cfg.width // heads
        scale = hd ** -0.5
        causal = torch.full((s, s), float("-inf"), device=h.device).triu(1)
        act = quick_gelu if cfg.activation == "quick_gelu" else F.gelu

        def split(x):
            return x.view(b, s, heads, hd).transpose(1, 2)

        for lp in tm.encoder.layers:
            x = lp.layer_norm1(h)
            att = lp.self_attn
            q, k, v = split(att.q_proj(x)), split(att.k_proj(x)), split(att.v_proj(x))
            scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale + causal
            probs = torch.softmax(scores, dim=-1).to(dtype)
            out = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, cfg.width)
            h = h + att.out_proj(out)
            h = h + lp.mlp.fc2(act(lp.mlp.fc1(lp.layer_norm2(h))))
        return tm.final_layer_norm(h)
