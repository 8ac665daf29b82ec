"""The samplers' arithmetic for the reference, in float32: the DDIM schedule and
its steps (diffusers' ``DDIMScheduler`` with SD's scaled-linear betas, eta 0),
classifier-free guidance, Prompt-to-Prompt's attention edit (refine, reweight,
self-attention replace) and LocalBlend, after google/prompt-to-prompt and
PnP-Inversion's ``run_editing_p2p.py``; Blended Latent Diffusion's blend.

The UNet batch holds, per image, its unconditional rows and then its two
conditional rows [source, target]; ``P2PAttention`` edits the target rows of
every image of a batch from the image's own source row.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.models import attention_probs, matmul, plain_attention

LB_THRESHOLD = 0.3  # LocalBlend keeps the edit where the normalised map exceeds this
LB_START = 0.2  # and acts after this share of the steps
SELF_EDIT_MAX_SEQ = 32 * 32  # P2P replaces self-attention at maps this small


@dataclasses.dataclass(frozen=True)
class Schedule:
    alphas: np.ndarray  # alphas_cumprod (1000,), f64 from f32 betas
    timesteps: tuple
    ratio: int

    def alpha(self, t: int) -> float:
        return float(self.alphas[t] if t >= 0 else self.alphas[0])


def make_schedule(cfg: dict, steps: int) -> Schedule:
    """cfg: the configuration file's ``scheduler`` group."""
    n = cfg["num_train_timesteps"]
    betas = (np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5, n,
                         dtype=np.float64) ** 2).astype(np.float32)
    alphas = np.cumprod(1.0 - betas.astype(np.float64)).astype(np.float32)
    ratio = n // steps
    ts = (np.arange(steps) * ratio)[::-1] + cfg["steps_offset"]
    return Schedule(alphas, tuple(int(t) for t in ts), ratio)


def ddim_step(s: Schedule, eps, t: int, x):
    a, prev = s.alpha(t), s.alpha(t - s.ratio)
    x0 = (x - (1 - a) ** 0.5 * eps) / a ** 0.5
    return prev ** 0.5 * x0 + (1 - prev) ** 0.5 * eps


def ddim_inverse_step(s: Schedule, eps, t: int, x):
    a, nxt = s.alpha(min(t - s.ratio, len(s.alphas) - 1)), s.alpha(t)
    x0 = (x - (1 - a) ** 0.5 * eps) / a ** 0.5
    return nxt ** 0.5 * x0 + (1 - nxt) ** 0.5 * eps


def add_noise(s: Schedule, x0, noise, t: int):
    a = s.alpha(t)
    return a ** 0.5 * x0 + (1 - a) ** 0.5 * noise


def cfg_mix(eps_u, eps_c, g: float):
    return eps_u + g * (eps_c - eps_u)


class P2PAttention:
    """The attention edit of one UNet call over N images of ``rows`` rows each
    (the last two conditional: source, target). Tensors per image, stacked
    (N, ...): ``mapper``/``alphas`` (refinement), ``eq`` (reweighting, or
    None), ``alpha_words`` (77,) this step's cross-replace weights;
    ``self_replace`` whether the step lies in the self-replace window;
    ``lb`` a dict that gathers the source and target rows' pre-edit
    cross-attention maps at LocalBlend's sites."""

    def __init__(self, rows: int, mapper, alphas, eq, alpha_words, self_replace: bool,
                 lb: Optional[dict]):
        self.rows, self.u = rows, rows - 2
        self.mapper, self.alphas, self.eq = mapper % 77, alphas, eq
        self.alpha_words, self.self_replace, self.lb = alpha_words, self_replace, lb

    def attend(self, site, q, k, v, scale):
        u = self.u
        if site.cross:
            probs = attention_probs(q, k, scale)
            pv = probs.view((-1, self.rows) + probs.shape[1:])  # (N, R, H, Sq, 77)
            src, tgt = pv[:, u], pv[:, u + 1]
            if self.lb is not None and site.lb_slot >= 0:
                maps = pv[:, u:].sum(2)  # (N, 2, Sq, 77), summed over heads
                self.lb["sum"] = maps if "sum" not in self.lb else self.lb["sum"] + maps
                self.lb["count"] = self.lb.get("count", 0) + probs.shape[1]
            idx = self.mapper[:, None, None, :].expand(src.shape)
            new = torch.gather(src, -1, idx) * self.alphas[:, None, None]
            new = new + tgt * (1 - self.alphas[:, None, None])
            if self.eq is not None:
                new = new * self.eq[:, None, None]
            aw = self.alpha_words[:, None, None]
            new = new * aw + (1 - aw) * tgt
            pv = torch.cat([pv[:, : u + 1], new[:, None]], dim=1)
            return matmul(pv.reshape(probs.shape), v)
        if site.resolution ** 2 > SELF_EDIT_MAX_SEQ:
            return None
        out = plain_attention(q, k, v, scale)
        if self.self_replace:
            qi, ki, vi = (t.view((-1, self.rows) + t.shape[1:]) for t in (q, k, v))
            base = attention_probs(qi[:, u], ki[:, u], scale)  # (N, H, S, S)
            oi = out.view((-1, self.rows) + out.shape[1:]).clone()
            oi[:, u + 1] = matmul(base, vi[:, u + 1])
            out = oi.view(out.shape)
        return out


def local_blend_maps(lb: dict, selector, latent: int):
    """The normalised LocalBlend maps (N, 2, latent, latent) of the gathered
    cross-attention (``lb``: sum (N, 2, res², 77) and the count of maps
    summed), read at each row's blend word (``selector`` (N, 2, 77))."""
    n, rows, pix, _ = lb["sum"].shape
    res = int(round(pix ** 0.5))
    m = (lb["sum"] * selector[:, :, None]).sum(-1) / lb["count"]
    m = F.max_pool2d(m.view(n * rows, 1, res, res), 3, stride=1, padding=1)
    m = F.interpolate(m, size=(latent, latent), mode="nearest").view(n, rows, latent, latent)
    return m / m.amax(dim=(2, 3), keepdim=True)


def local_blend(src, tgt, maps, threshold: float = LB_THRESHOLD):
    """The target latents (N, C, h, w) kept where either row's map exceeds the
    threshold, the source's elsewhere."""
    keep = ((maps[:, 0] > threshold) | (maps[:, 1] > threshold)).to(tgt.dtype)[:, None]
    return src + keep * (tgt - src)
