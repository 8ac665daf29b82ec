"""StyleDiffusion's controls (port of ``pnpinversion_tpu/control/stylediffusion.py``):
the learned V-context mapping, the tau-parameterised P2P controller around
it, and the capture of the 16^2 cross maps that supervise the training.

As everywhere in the port, a control sees the UNet's rows image-major, N
images of R rows each; ``tensors["img_tokens"]`` (N, 197, width) and the
networks (``models/stylediffusion.py``) carry a leading image axis, so each
image's rows are mapped by its own networks.
"""
from __future__ import annotations

import dataclasses

import torch

from pnpinversion_tpu_torch.control.base import AttnSite, BaseControl
from pnpinversion_tpu_torch.control.p2p import SELF_EDIT_MAX_SEQ, P2PControl
from pnpinversion_tpu_torch.models.stylediffusion import forward_embed, mapper_at_step


def _images(x: torch.Tensor, rows: int) -> torch.Tensor:
    """(N * rows, ...) -> (N, rows, ...)."""
    return x.view((-1, rows) + x.shape[1:])


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(N, rows, ...) -> (N * rows, ...)."""
    return x.reshape((-1,) + x.shape[2:])


class StyleStoreControl(BaseControl):
    """Records the cross maps of the LocalBlend sites (16^2 at SD1.4) under
    ``sd_maps_<slot>``: the inversion's supervision maps."""

    def needs_probs(self, site: AttnSite) -> bool:
        return site.is_cross and site.lb_slot >= 0

    def probs_hook(self, site, probs, tensors, state, step):
        state = dict(state)
        state[f"sd_maps_{site.lb_slot}"] = probs
        return probs, state


@dataclasses.dataclass(frozen=True, eq=True)
class StyleDiffusionSpec:
    """The edit passes' static settings, in steps."""

    batch_size: int
    num_steps: int
    v_replace_end: int  # int(tau_v * T): target rows mapped while step < this
    uncond_self_start: int = 0
    uncond_self_end: int = 0  # the tau_u window; (0, 0) is off


class StyleDiffusionControl(BaseControl):
    """The edit passes' control: each image's rows are [uncond x B, cond x
    B]; its cond source row's V context is always mapped by the step's
    network, its target rows' only while step < v_replace_end; the wrapped
    P2P controller (or none: the reconstruction pass) edits as usual. The
    tau_u window, when on, also replaces each image's uncond target rows'
    self-attention probs (at maps of at most 32^2) by its uncond source
    row's, and then takes the self-attention sites through the probs path,
    where P2P's self replace happens in the hook.

    tensors: 'img_tokens' (N, 197, width), 'sd_mapper' (the stacked
    networks (N, T, ...)) and the wrapped P2P tensors."""

    def __init__(self, spec: StyleDiffusionSpec, p2p: "P2PControl | None" = None):
        self.spec = spec
        self.p2p = p2p

    def init_state(self, batch_size, heads=8, max_words=77, device=None, images=1):
        if self.p2p is None:
            return {}
        return self.p2p.init_state(batch_size, heads, max_words, device, images)

    def value_context_hook(self, site, context, tensors, state, step):
        if not site.is_cross:
            return context
        B = self.spec.batch_size
        ctx = _images(context, 2 * B)
        cond = ctx[:, B:]
        mapped = forward_embed(mapper_at_step(tensors["sd_mapper"], step), cond,
                               tensors["img_tokens"])
        if B > 1 and step >= self.spec.v_replace_end:  # tau_v: the target rows unmapped
            mapped = torch.cat([mapped[:, :1], cond[:, 1:].to(mapped.dtype)], dim=1)
        return _rows(torch.cat([ctx[:, :B].to(mapped.dtype), mapped], dim=1))

    def _uncond_window(self) -> bool:
        return self.spec.uncond_self_end > self.spec.uncond_self_start

    def needs_probs(self, site: AttnSite) -> bool:
        if not site.is_cross:
            return self._uncond_window() and site.seq_len <= SELF_EDIT_MAX_SEQ
        return self.p2p.needs_probs(site) if self.p2p is not None else False

    def attention_override(self, site, q, k, v, scale, tensors, state, step):
        if site.is_cross or self.p2p is None or self._uncond_window():
            return None
        return self.p2p.attention_override(site, q, k, v, scale, tensors, state, step)

    def probs_hook(self, site, probs, tensors, state, step):
        if site.is_cross:
            if self.p2p is not None:
                probs, state = self.p2p.probs_hook(site, probs, tensors, state, step)
            return probs, state
        # a self-attention site of at most 32^2 with the tau_u window on
        s, B = self.spec, self.spec.batch_size
        pi = _images(probs, 2 * B).clone()
        if self.p2p is not None:
            ps = self.p2p.spec
            if (site.seq_len <= ps.self_edit_max_seq
                    and ps.self_replace_start <= step < ps.self_replace_end):
                pi[:, B + 1:] = pi[:, B:B + 1]
        if s.uncond_self_start <= step < s.uncond_self_end:
            pi[:, 1:B] = pi[:, :1]
        return _rows(pi), state

    def step_callback(self, latents, tensors, state, step):
        if self.p2p is None:
            return latents, state
        return self.p2p.step_callback(latents, tensors, state, step)


class StyleTrainControl(StyleStoreControl):
    """The training's control: the V context mapped by the network being
    trained (``tensors["sd_mapper_i"]``, one step's (N, ...)), and the 16^2
    cross maps recorded. map_rows 'all' maps every row (the single-branch
    cond call, one row per image); 'cond_half' maps the second half of each
    image's [uncond; cond] rows (the call that advances the latent)."""

    def __init__(self, map_rows: str = "all"):
        self.map_rows = map_rows

    def value_context_hook(self, site, context, tensors, state, step):
        if not site.is_cross:
            return context
        mp, img = tensors["sd_mapper_i"], tensors["img_tokens"]
        n = img.shape[0]
        ctx = context.view((n, -1) + context.shape[1:])
        if self.map_rows == "cond_half":
            h = ctx.shape[1] // 2
            mapped = forward_embed(mp, ctx[:, h:], img)
            return _rows(torch.cat([ctx[:, :h].to(mapped.dtype), mapped], dim=1))
        return _rows(forward_embed(mp, ctx, img))
