"""The attention-control dispatch protocol (port of
``pnpinversion_tpu/control/base.py``).

Every attention call site of the UNet carries a static ``AttnSite`` and is
routed through a ``BaseControl``. Per-image tensors (mappers, alpha
schedules, equalizers, ...) live in ``tensors`` and mutable state (accumulated
maps, ...) in ``state``; both are plain dicts of tensors the caller threads
through the sampling loop. The step index is a Python int here: PyTorch runs
eagerly, so step-dependent behaviour is an ordinary ``if``.

Hooks (all optional): ``qkv_hook``, ``value_context_hook``,
``attention_override``, ``needs_probs``/``probs_hook``, ``step_callback``,
``resnet_hook``; ``init_state`` makes the state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

Tensors = Dict[str, Any]
State = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AttnSite:
    """Static metadata for one attention call site.

    index: transformer-block index in execution order (down -> mid -> up);
    place: 'down' | 'mid' | 'up'; resolution: h == w of the feature map;
    is_cross: text cross-attention or self-attention; heads: head count;
    place_index: index within the <=32^2 store list of its (place, is_cross)
    bucket, -1 when the map is larger; lb_slot: slot in the LocalBlend
    cross-map store, or -1.
    """

    index: int
    place: str
    resolution: int
    is_cross: bool
    heads: int
    place_index: int = -1
    lb_slot: int = -1

    @property
    def seq_len(self) -> int:
        return self.resolution * self.resolution


class BaseControl:
    """No-op base; subclasses override a subset of hooks."""

    def init_state(self, batch_size: int, heads: int = 8, max_words: int = 77,
                   device=None) -> State:
        return {}

    def qkv_hook(self, site: AttnSite, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 tensors: Tensors, state: State, step: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return q, k, v

    def value_context_hook(self, site: AttnSite, context: torch.Tensor, tensors: Tensors,
                           state: State, step: int) -> torch.Tensor:
        """Rewrite the context used for the V projection only."""
        return context

    def attention_override(self, site: AttnSite, q, k, v, scale: float, tensors: Tensors,
                           state: State, step: int):
        """Full takeover of one site: return (out (B, H, Sq, D), state), or None
        to take the standard path."""
        return None

    def needs_probs(self, site: AttnSite) -> bool:
        return False

    def probs_hook(self, site: AttnSite, probs: torch.Tensor, tensors: Tensors, state: State,
                   step: int) -> Tuple[torch.Tensor, State]:
        return probs, state

    def step_callback(self, latents: torch.Tensor, tensors: Tensors, state: State,
                      step: int) -> Tuple[torch.Tensor, State]:
        return latents, state

    def resnet_hook(self, block_key: str, hidden: torch.Tensor, tensors: Tensors,
                    state: State, step: int) -> torch.Tensor:
        """Called on decoder resnets' residual branch (after conv2, before the
        shortcut add)."""
        return hidden


class NoControl(BaseControl):
    pass


NO_CONTROL = NoControl()
