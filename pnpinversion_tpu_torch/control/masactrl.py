"""MasaCtrl mutual self-attention control (port of
``pnpinversion_tpu/control/masactrl.py``).

At self-attention sites whose transformer-block index is at least
``start_layer`` (SD1.4 has 16 blocks; the default 10 takes the two finest
decoder levels) and from step ``start_step`` on, every row of each CFG half
attends to the K/V of that half's first row (the source branch): q is kept,
so the target keeps its layout and borrows the source's appearance. A K/V
rewrite, so the flash kernel still serves these sites.

Batch layout: every caller edits two prompts per image, [source, target],
so each image's UNet rows are [uncond x 2, cond x 2], and N images are N
such groups one after the other (image-major). Every hook views the UNet
batch as (N, 2 halves, 2 rows, ...), so each half takes its own image's
source row, where the JAX package's hooks see one image's rows under
``vmap`` (and read B from them). Step-dependent behaviour is a Python
``if`` on the step index.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from pnpinversion_tpu_torch.control.base import AttnSite, BaseControl, lead_rows
from pnpinversion_tpu_torch.ops.attention import fused_attention

PROMPTS = 2  # prompts per image, [source, target]: a CFG half's rows


@dataclasses.dataclass(frozen=True, eq=True)
class MasaCtrlSpec:
    start_step: int = 4
    start_layer: int = 10
    total_layers: int = 16  # SD; 70 for SDXL
    union: bool = False  # MutualSelfAttentionControlUnion


def resize_maps(x: torch.Tensor, res: int, mode: str) -> torch.Tensor:
    """(N, h, w) maps -> (N, res * res) f32, sampled as ``jax.image.resize``
    samples them: at half-pixel centres ("nearest" is torch's
    "nearest-exact"), and "bilinear" with an antialiasing triangle filter
    when it shrinks."""
    x = x.float()[:, None]
    if mode == "nearest":
        x = F.interpolate(x, size=(res, res), mode="nearest-exact")
    else:
        x = F.interpolate(x, size=(res, res), mode="bilinear", align_corners=False,
                          antialias=True)
    return x.reshape(x.shape[0], res * res)


def _masked_fg_bg_attention(q_t, k_s, v_s, scale, key_mask, query_mask):
    """Target queries attend to source K/V twice, once over the foreground
    keys and once over the background ones, blended per query pixel; scores
    and softmaxes in f32.

    q_t/k_s/v_s: (..., H, S, D); key_mask/query_mask: (..., S) in {0, 1},
    with q_t's leading dims.
    """
    s = torch.matmul(q_t.float(), k_s.float().transpose(-1, -2)) * scale
    neg = torch.finfo(torch.float32).min
    km = key_mask[..., None, None, :]
    v = v_s.float()
    out_fg = torch.matmul(torch.softmax(s + torch.where(km == 0, neg, 0.0), -1), v)
    out_bg = torch.matmul(torch.softmax(s + torch.where(km == 1, neg, 0.0), -1), v)
    qm = query_mask[..., None, :, None]
    return (out_fg * qm + out_bg * (1.0 - qm)).to(q_t.dtype)


def _halves(x: torch.Tensor) -> torch.Tensor:
    """(N * 4, H, S, D) -> (N, 2, 2, H, S, D): image, CFG half, [source, target]."""
    return x.view((-1, 2, PROMPTS) + x.shape[1:])


def _source_and_target(q, k, v, scale, masked_target):
    """Each half's source row attends to its own K/V; its target row to the
    source's K/V through ``masked_target(q_t, k_s, v_s)`` (N, 2, H, S, D).
    Returns the (N * 4, H, S, D) output."""
    qi, ki, vi = _halves(q), _halves(k), _halves(v)
    k_s, v_s = ki[:, :, 0], vi[:, :, 0]
    flat = (-1,) + q.shape[1:]
    out_src = fused_attention(qi[:, :, 0].reshape(flat), k_s.reshape(flat), v_s.reshape(flat),
                              scale).view(k_s.shape)
    out_tgt = masked_target(qi[:, :, 1], k_s, v_s)
    return torch.stack([out_src, out_tgt], dim=2).reshape(q.shape)


class MasaCtrlMaskControl(BaseControl):
    """MutualSelfAttentionControlMask: source and target masks steer the
    foreground/background split. tensors: 'mask_s'/'mask_t' (N, Hm, Wm) in
    {0, 1}, one pair per image, resized to each site's resolution."""

    def __init__(self, spec: MasaCtrlSpec):
        self.spec = spec

    def attention_override(self, site, q, k, v, scale, tensors, state, step):
        if site.is_cross or site.index < self.spec.start_layer:
            return None
        if step < self.spec.start_step:  # plain attention on each row's own q/k/v
            return fused_attention(q, k, v, scale), state
        res = site.resolution
        mask_s = resize_maps(tensors["mask_s"], res, "nearest")[:, None]  # (N, 1, S)
        mask_t = resize_maps(tensors["mask_t"], res, "nearest")[:, None]
        out = _source_and_target(q, k, v, scale, lambda q_t, k_s, v_s: _masked_fg_bg_attention(
            q_t, k_s, v_s, scale, mask_s, mask_t))
        return out, state


class MasaCtrlMaskAutoControl(BaseControl):
    """MutualSelfAttentionControlMaskAuto: the masks come at run time from
    the mean over this step's ``agg_res``^2 cross-attention maps of chosen
    tokens. tensors: 'ref_token_mask'/'cur_token_mask' (N, 77) selectors;
    ``thres`` binarises."""

    def __init__(self, spec: MasaCtrlSpec, thres: float = 0.1, agg_res: int = 16):
        self.spec = spec
        self.thres = thres
        self.agg_res = agg_res

    def init_state(self, batch_size, heads=8, max_words=77, device=None, images=1):
        """The step's cross-map sum (N * 2 * batch_size rows, agg_res^2, 77),
        f32, and the number of maps in it (a Python count: the UNet's sites
        fix it)."""
        n = self.agg_res * self.agg_res
        return {"mc_cross_sum": torch.zeros((images * 2 * batch_size, n, max_words),
                                            dtype=torch.float32, device=device),
                "mc_cross_cnt": 0.0}

    def needs_probs(self, site: AttnSite) -> bool:
        return site.is_cross and site.resolution == self.agg_res

    def probs_hook(self, site, probs, tensors, state, step):
        state["mc_cross_sum"] += probs.mean(dim=1)
        state["mc_cross_cnt"] += 1.0
        return probs, state

    def _agg_mask(self, state, selector, row, res):
        """Each image's mask from its row ``row``'s mean map of the selected
        tokens, min-max normalised: (N, res * res)."""
        n = self.agg_res
        sums = state["mc_cross_sum"]
        maps = (sums.view((-1, 2 * PROMPTS) + sums.shape[1:])[:, row]
                / max(state["mc_cross_cnt"], 1.0))
        img = (maps * selector[:, None, :]).sum(-1).view(-1, n, n)
        lo = img.amin(dim=(1, 2), keepdim=True)
        img = (img - lo) / torch.clamp(img.amax(dim=(1, 2), keepdim=True) - lo, min=1e-8)
        return resize_maps(img, res, "bilinear")

    def step_callback(self, latents, tensors, state, step):
        # after each step the aggregation starts again
        state["mc_cross_sum"].zero_()
        state["mc_cross_cnt"] = 0.0
        return latents, state

    def attention_override(self, site, q, k, v, scale, tensors, state, step):
        if site.is_cross or site.index < self.spec.start_layer:
            return None
        if step < self.spec.start_step:
            return fused_attention(q, k, v, scale), state
        if state["mc_cross_cnt"] > 0:
            # the source mask from the cond source row (2), the target's from
            # the cond target row (3)
            res = site.resolution
            mask_s = (self._agg_mask(state, tensors["ref_token_mask"], 2, res)
                      >= self.thres).float()[:, None]
            mask_t = (self._agg_mask(state, tensors["cur_token_mask"], 3, res)
                      >= self.thres).float()[:, None]

            def target(q_t, k_s, v_s):
                return _masked_fg_bg_attention(q_t, k_s, v_s, scale, mask_s, mask_t)
        else:
            def target(q_t, k_s, v_s):
                flat = (-1,) + q_t.shape[2:]
                return fused_attention(q_t.reshape(flat), k_s.reshape(flat), v_s.reshape(flat),
                                       scale).view(q_t.shape)
        return _source_and_target(q, k, v, scale, target), state


class MasaCtrlControl(BaseControl):
    def __init__(self, spec: MasaCtrlSpec):
        self.spec = spec

    def qkv_hook(self, site: AttnSite, q, k, v, tensors, state, step):
        s = self.spec
        if site.is_cross or site.index < s.start_layer:
            return q, k, v
        active = step >= s.start_step
        if s.union:
            # each row attends to concat(its half's source K/V, its own K/V)
            # over 2S keys; a source row so gets its own K/V twice, whose
            # attention equals its plain attention, as before the start step
            # every row does
            if not active:
                return q, torch.cat([k, k], dim=2), torch.cat([v, v], dim=2)
            return (q, torch.cat([lead_rows(k, PROMPTS), k], dim=2),
                    torch.cat([lead_rows(v, PROMPTS), v], dim=2))
        if not active:
            return q, k, v
        return q, lead_rows(k, PROMPTS), lead_rows(v, PROMPTS)
