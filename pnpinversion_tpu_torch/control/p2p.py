"""Prompt-to-Prompt attention control (port of ``pnpinversion_tpu/control/p2p.py``):
refine/replace cross-attention edits, reweighting, self-attention replace and
LocalBlend.

Batch layout (the reference's CFG batch): for each image the UNet sees [uncond
rows, cond rows]; only the cond half is edited and its first row (the source
prompt) is the edit base. N images are N such groups of rows one after the
other (image-major), so every hook views the UNet batch as (N, rows, ...) and
each image is edited with its own tensors (stacked over the images by
``stack_tensors``) and its own source row, as the JAX package's ``vmap`` over
images does. Step-dependent behaviour is a Python ``if`` on the step index.
The LocalBlend map store is accumulated in place (it is created fresh for
every edit by ``init_state``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pnpinversion_tpu_torch.control.base import AttnSite, BaseControl
from pnpinversion_tpu_torch.ops.attention import apply_probs, attention_probs, fused_attention
from pnpinversion_tpu_torch.utils import text as text_utils
from pnpinversion_tpu_torch.utils.observability import host_sync

SELF_EDIT_MAX_SEQ = 32 * 32  # P2P's self-attention replace applies at <= 32^2 maps
LB_START = 0.2  # LocalBlend starts after this fraction of the steps
LB_THRESHOLD = 0.3  # LocalBlend keeps the edit where the normalised map exceeds this


@dataclasses.dataclass(frozen=True, eq=True)
class P2PSpec:
    """Static description of a P2P controller stack (one image's rows)."""

    kind: str  # 'replace' | 'refine'
    batch_size: int  # number of prompts (source first)
    num_steps: int
    self_replace_start: int
    self_replace_end: int
    reweight: bool = False
    local_blend: bool = False
    lb_start_blend: int = 10  # int(LB_START * num_steps)
    num_lb_slots: int = 5
    lb_res: int = 16
    latent_size: int = 64
    # self-attention replace applies at maps of at most this many pixels: 32^2
    # for P2P, 16^2 for edit-friendly DDPM's copy of the controller
    self_edit_max_seq: int = SELF_EDIT_MAX_SEQ
    # rows in the uncond half; -1 == batch_size (the reference's CFG batch).
    # The source-free fused scan drops the uncond-source row: batch_size - 1.
    uncond_rows: int = -1

    @property
    def half(self) -> int:
        return self.uncond_rows if self.uncond_rows >= 0 else self.batch_size

    @property
    def rows(self) -> int:
        """UNet rows per image."""
        return self.half + self.batch_size


class P2PControl(BaseControl):
    def __init__(self, spec: P2PSpec):
        self.spec = spec

    def init_state(self, batch_size: int, heads: int = 8, max_words: int = 77,
                   device=None, images: int = 1) -> Dict[str, torch.Tensor]:
        """The LocalBlend store: (slots, images * batch_size, H, res^2, 77),
        image-major rows."""
        s = self.spec
        if not s.local_blend:
            return {}
        return {"lb_maps": torch.zeros(
            (s.num_lb_slots, images * s.batch_size, heads, s.lb_res * s.lb_res, max_words),
            dtype=torch.float32, device=device)}

    def needs_probs(self, site: AttnSite) -> bool:
        # cross maps are small (Sk=77) and edited; self-attention edits go
        # through attention_override, which materialises one row's probs only
        return site.is_cross

    def attention_override(self, site, q, k, v, scale, tensors, state, step):
        """Self-attention replace: fused attention over every row of every
        image (one flash launch at 32^2 on CUDA), then, inside the replace
        window, each image's edited rows are overwritten with its source
        row's probs @ v_row."""
        s = self.spec
        if site.is_cross or site.seq_len > s.self_edit_max_seq:
            return None
        out = fused_attention(q, k, v, scale)
        if s.self_replace_start <= step < s.self_replace_end:
            B, lo = s.batch_size, s.half
            qi, ki, vi, oi = (x.view((-1, s.rows) + x.shape[1:]) for x in (q, k, v, out))
            base_probs = attention_probs(qi[:, lo], ki[:, lo], scale)  # (N, H, S, S)
            oi[:, lo + 1 : lo + B] = apply_probs(
                base_probs[:, None].expand(-1, B - 1, -1, -1, -1), vi[:, lo + 1 : lo + B])
        return out, state

    def probs_hook(self, site, probs, tensors, state, step):
        """Cross-attention edit of each image's cond half (self-attention
        sites never get here: needs_probs is False for them)."""
        s = self.spec
        B, lo = s.batch_size, s.half
        pi = probs.view((-1, s.rows) + probs.shape[1:])  # (N, rows, H, Sq, 77)
        cond = pi[:, lo : lo + B]
        if s.local_blend and site.lb_slot >= 0:
            # pre-edit cond maps, summed over steps
            state["lb_maps"][site.lb_slot] += cond.reshape((-1,) + cond.shape[2:])
        base, repl = cond[:, 0], cond[:, 1:]  # (N, H, Sq, 77), (N, B-1, H, Sq, 77)
        alpha_words = tensors["cross_replace_alpha"][:, step]  # (N, B-1, 1, 1, 77)
        mapper = tensors["mapper"]
        if s.kind == "replace":
            new = torch.einsum("nhpw,nbwv->nbhpv", base, mapper)
        else:  # refine: a gather of the base maps' words, -1 wrapping as in numpy
            idx = mapper.remainder(base.shape[-1])[:, :, None, None, :].expand(repl.shape)
            base_g = torch.gather(base[:, None].expand(repl.shape), -1, idx)
            alphas = tensors["alphas"][:, :, None, None, :]
            new = base_g * alphas + repl * (1.0 - alphas)
        if s.reweight:
            new = new * tensors["equalizer"][:, :, None, None, :]
        new = new * alpha_words + (1.0 - alpha_words) * repl
        out = torch.cat([pi[:, : lo + 1], new], dim=1)
        return out.view(probs.shape), state

    def step_callback(self, latents, tensors, state, step):
        """LocalBlend: outside each image's source row, keep the edit only
        where the blend words' accumulated cross-attention is strong."""
        s = self.spec
        if not s.local_blend or step + 1 <= s.lb_start_blend:
            return latents, state
        maps = state["lb_maps"]  # (slots, N*B, H, res*res, 77)
        nslots, rows, H, _, W = maps.shape
        maps = maps.transpose(0, 1).reshape(rows, nslots * H, s.lb_res, s.lb_res, W)
        selector = tensors["lb_alpha_layers"].reshape(rows, 1, 1, 1, W)
        m = (maps * selector).sum(-1).mean(1)  # (N*B, res, res)
        m = F.max_pool2d(m[:, None], 3, stride=1, padding=1)  # 3x3 max, SAME
        m = F.interpolate(m, size=(s.latent_size, s.latent_size), mode="nearest")[:, 0]
        m = m / m.amax(dim=(1, 2), keepdim=True)
        m = (m > LB_THRESHOLD).view(-1, s.batch_size, s.latent_size, s.latent_size)
        mask = (m[:, :1] | m).to(latents.dtype)[..., None]  # union with the source row's
        li = latents.view((-1, s.batch_size) + latents.shape[1:])
        return (li[:, :1] + mask * (li - li[:, :1])).view(latents.shape), state


# ---------------------------------------------------------------------------
# host-side construction of the control and its tensors
# ---------------------------------------------------------------------------

def make_p2p_control(
    prompts: Sequence[str],
    tokenizer,
    num_steps: int = 50,
    cross_replace_steps=0.4,
    self_replace_steps=0.6,
    is_replace_controller: bool = False,
    blend_words: Optional[Sequence] = None,
    eq_params: Optional[dict] = None,
    num_lb_slots: int = 5,
    lb_res: int = 16,
    latent_size: int = 64,
    self_edit_max_seq: int = SELF_EDIT_MAX_SEQ,
    device=None,
) -> Tuple[P2PControl, Dict[str, torch.Tensor]]:
    """Build (control, tensors) for one image's edit; tensors are f32
    (mapper int64) on ``device``, with the JAX package's shapes (the hooks
    take them stacked over the images: ``stack_tensors``)."""
    B = len(prompts)
    if isinstance(self_replace_steps, float):
        self_replace_steps = (0.0, self_replace_steps)
    spec = P2PSpec(
        kind="replace" if is_replace_controller else "refine",
        batch_size=B,
        num_steps=num_steps,
        self_replace_start=int(num_steps * self_replace_steps[0]),
        self_replace_end=int(num_steps * self_replace_steps[1]),
        reweight=eq_params is not None,
        local_blend=blend_words is not None,
        lb_start_blend=int(LB_START * num_steps),
        num_lb_slots=num_lb_slots,
        lb_res=lb_res,
        latent_size=latent_size,
        self_edit_max_seq=self_edit_max_seq,
    )

    def tensor(x, dtype=torch.float32):
        if device is not None:
            host_sync("control", device)
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    tensors = {"cross_replace_alpha": tensor(text_utils.get_time_words_attention_alpha(
        prompts, num_steps,
        cross_replace_steps if isinstance(cross_replace_steps, dict)
        else {"default_": cross_replace_steps},
        tokenizer))}
    if spec.kind == "replace":
        tensors["mapper"] = tensor(text_utils.get_replacement_mapper(prompts, tokenizer))
    else:
        mapper, alphas = text_utils.get_refinement_mapper(prompts, tokenizer)
        tensors["mapper"] = tensor(mapper, torch.int64)
        tensors["alphas"] = tensor(alphas)
    if spec.reweight:
        tensors["equalizer"] = tensor(text_utils.get_equalizer(
            prompts[1], eq_params["words"], eq_params["values"], tokenizer))
    if spec.local_blend:
        tensors["lb_alpha_layers"] = tensor(_word_selector(prompts, blend_words, tokenizer))
    return P2PControl(spec), tensors


def stack_tensors(per_image: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """One image's control tensors each, as one dict with a leading image
    axis: each image of a batch is then edited with its own."""
    return {k: torch.stack([t[k] for t in per_image]) for k in per_image[0]}


def _word_selector(prompts, words, tokenizer, max_words: int = 77) -> np.ndarray:
    sel = np.zeros((len(prompts), max_words), dtype=np.float32)
    for i, (prompt, ws) in enumerate(zip(prompts, words)):
        if isinstance(ws, str):
            ws = [ws]
        for w in ws:
            sel[i, text_utils.get_word_inds(prompt, w, tokenizer)] = 1.0
    return sel
