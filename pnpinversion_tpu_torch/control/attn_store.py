"""Cross-attention map capture, pix2pix-zero's (port of
``pnpinversion_tpu/control/attn_store.py``): every cross-attention site's
softmax probs go into the control state under ``xattn_<site index>``. The
editor recomputes the reference maps inside each step, so the state holds one
step's maps only."""
from __future__ import annotations

from pnpinversion_tpu_torch.control.base import AttnSite, BaseControl


class CrossAttnStoreControl(BaseControl):
    """Stores the f32 softmax probs (rows, H, Sq, 77) of every cross-attention
    site, unchanged."""

    def needs_probs(self, site: AttnSite) -> bool:
        return site.is_cross

    def probs_hook(self, site, probs, tensors, state, step):
        state = dict(state)
        state[f"xattn_{site.index}"] = probs
        return probs, state
