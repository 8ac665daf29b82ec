"""EDICT's P2P-style attention takeover (port of
``pnpinversion_tpu/control/edict_p2p.py``).

The reference runs three batch-1 UNet calls per update (uncond, base-cond
saving every attention map, edit-cond reading them). As in the JAX package,
one call runs the three rows [uncond, base-cond, edit-cond] of each image on
the same latent and edits in the batch:

- self-attention: full takeover, the edit row gets the base row's q and k
  (so the fused flash path survives);
- cross-attention: the token-wise splice
  ``attn * (1 - mask) + attn_base[..., indices] * mask``, with mask and
  indices from a SequenceMatcher alignment of the two prompts' tokens.

The default windows (start 0, end 1) keep both takeovers on at every step,
so no step gate is needed. A batch of N images reaches the hooks as N groups
of 3 rows (image-major); each image's ``edit_mask``/``edit_indices`` (and the
optional ``token_weights``) are stacked on a leading image axis.
"""
from __future__ import annotations

from difflib import SequenceMatcher
from typing import Dict

import numpy as np
import torch

from pnpinversion_tpu_torch.control.base import AttnSite, BaseControl

ROWS = 3  # [uncond, base-cond, edit-cond] per image


def _base_over_edit(x: torch.Tensor) -> torch.Tensor:
    """x with each image's edit row (2 of 3) replaced by its base row (1): a
    copy with x's strides, so heads split from (B, S, H*D) stay as the flash
    kernel takes them."""
    out = x.clone()
    rows = out.view((-1, ROWS) + x.shape[1:])
    rows[:, 2].copy_(rows[:, 1])
    return out


class EdictP2PControl(BaseControl):
    def __init__(self, num_steps: int = 50, tokens_start: float = 0.0, tokens_end: float = 1.0,
                 spatial_start: float = 0.0, spatial_end: float = 1.0):
        self.num_steps = num_steps
        self.tokens_window = (tokens_start, tokens_end)
        self.spatial_window = (spatial_start, spatial_end)

    def qkv_hook(self, site: AttnSite, q, k, v, tensors, state, step):
        if site.is_cross:
            return q, k, v
        return _base_over_edit(q), _base_over_edit(k), v

    def needs_probs(self, site: AttnSite) -> bool:
        return site.is_cross

    def probs_hook(self, site, probs, tensors, state, step):
        rows = probs.view((-1, ROWS) + probs.shape[1:])  # (N, 3, H, Sq, Sk)
        n, sk = rows.shape[0], rows.shape[-1]
        mask = tensors["edit_mask"].view(n, 1, 1, sk).to(probs.dtype)
        index = tensors["edit_indices"].view(n, 1, 1, sk).expand(rows[:, 1].shape)
        spliced = torch.gather(rows[:, 1], -1, index)
        edited = rows[:, 2] * (1.0 - mask) + spliced * mask
        if "token_weights" in tensors:
            edited = edited * tensors["token_weights"].view(n, 1, 1, sk).to(probs.dtype)
        out = rows.clone()
        out[:, 2] = edited
        return out.view(probs.shape), state


def make_edict_p2p_tensors(prompt_base: str, prompt_edit: str, tokenizer, max_length: int = 77,
                           device=None) -> Dict[str, torch.Tensor]:
    """One image's takeover tensors: the SequenceMatcher alignment of the
    base and edit prompts' token ids (the reference's
    ``init_attention_edit``): ``edit_mask`` (77,) f32 and ``edit_indices``
    (77,) int64."""
    def pad(ids):
        ids = ids[:max_length]
        return ids + [tokenizer.pad_token_id] * (max_length - len(ids))

    tokens = pad(tokenizer.encode(prompt_base))
    tokens_edit = pad(tokenizer.encode(prompt_edit))
    mask = np.zeros(max_length, dtype=np.float32)
    indices = np.zeros(max_length, dtype=np.int64)
    target = np.arange(max_length, dtype=np.int64)
    for name, a0, a1, b0, b1 in SequenceMatcher(None, tokens, tokens_edit).get_opcodes():
        if b0 < max_length and (name == "equal" or (name == "replace" and a1 - a0 == b1 - b0)):
            mask[b0:b1] = 1
            indices[b0:b1] = target[a0:a1]
    return {"edit_mask": torch.as_tensor(mask, device=device),
            "edit_indices": torch.as_tensor(indices, device=device)}
