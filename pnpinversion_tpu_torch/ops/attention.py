"""Attention ops (port of ``pnpinversion_tpu/ops/attention.py``): the fused
path (the flash kernel on CUDA for long sequences), the probs-materialising
path and the control dispatch used by the UNet.

Probabilities are materialised only at sites whose controller edits or
records them (cross-attention and small self-attention); the long
self-attention sites, the FLOPs hot spot, go through the flash kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from pnpinversion_tpu_torch.control.base import NO_CONTROL, AttnSite, BaseControl
from pnpinversion_tpu_torch.ops.flash_attention import flash_attention


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, C) -> (B, H, S, D), a view."""
    b, s, c = x.shape
    return x.view(b, s, heads, c // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, C)."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def attention_probs(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """Softmax probabilities in f32. q, k: (B, H, S, D)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.softmax(scores, dim=-1)


def apply_probs(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.matmul(probs.to(v.dtype), v)


def use_flash(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The JAX package's shape rule for its Pallas kernel, on CUDA tensors:
    long self-attention whose sequences tile by 128."""
    s, sk = q.shape[2], k.shape[2]
    return q.is_cuda and s >= 1024 and s % 128 == 0 and sk % 128 == 0


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Attention without materialising probs where the flash kernel applies."""
    if use_flash(q, k):
        return flash_attention(q, k, v, scale)
    return apply_probs(attention_probs(q, k, scale), v)


def controlled_attention(attn, x: torch.Tensor, context: Optional[torch.Tensor],
                         site: AttnSite, control: BaseControl = NO_CONTROL, tensors=None,
                         state=None, step: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """One UNet attention call with the control dispatch.

    attn: a module with to_q, to_k, to_v and to_out[0] Linear layers.
    x: (B, S, C); context: (B, Sk, Ctx), or None for self-attention.
    """
    state = {} if state is None else state
    tensors = {} if tensors is None else tensors
    ctx = x if context is None else context
    heads = site.heads
    q = split_heads(attn.to_q(x), heads)
    k = split_heads(attn.to_k(ctx.to(x.dtype)), heads)
    ctx_v = control.value_context_hook(site, ctx, tensors, state, step)
    v = split_heads(attn.to_v(ctx_v.to(x.dtype)), heads)
    scale = q.shape[-1] ** -0.5

    override = control.attention_override(site, q, k, v, scale, tensors, state, step)
    if override is not None:
        out, state = override
        return attn.to_out[0](merge_heads(out)), state

    q, k, v = control.qkv_hook(site, q, k, v, tensors, state, step)
    if control.needs_probs(site):
        probs, state = control.probs_hook(site, attention_probs(q, k, scale), tensors,
                                          state, step)
        out = apply_probs(probs, v)
    else:
        out = fused_attention(q, k, v, scale)
    return attn.to_out[0](merge_heads(out)), state

