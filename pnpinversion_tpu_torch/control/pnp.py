"""Plug-and-Play (PnP) feature and self-attention injection (port of
``pnpinversion_tpu/control/pnp.py``):

- q/k injection from the source row at the self-attention of the decoder's
  transformer blocks but the first (``pnp_injection_sites``), within the
  first ``qk_t`` steps;
- residual-branch feature injection at ``up_blocks[1].resnets[1]`` within
  the first ``conv_t`` steps.

Batch layout: each image's UNet rows are [source latent, x (uncond), x
(cond)]; rows 1 and 2 take the source row's q/k (their own v) and conv
features. N images are N such groups one after the other (image-major), so
every hook takes each image's own source row (``ROWS`` rows per image),
where the JAX package's hooks see one image's rows under ``vmap``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from pnpinversion_tpu_torch.configs import UNetConfig
from pnpinversion_tpu_torch.control.base import AttnSite, BaseControl, lead_rows
from pnpinversion_tpu_torch.models.unet import enumerate_sites

ROWS = 3  # UNet rows per image in the injection loop, the source row first


def pnp_injection_sites(config: UNetConfig) -> Tuple[int, ...]:
    """Self-attention transformer-block indices to inject: every decoder
    attention block but the first one of the coarsest decoder level."""
    sites = enumerate_sites(config)
    up_self = [s for pair in sites for s in pair if s.place == "up" and not s.is_cross]
    return tuple(s.index for s in up_self[1:])


@dataclasses.dataclass(frozen=True, eq=True)
class PnPSpec:
    qk_t: int  # number of leading steps with q/k injection (int(0.5 * T))
    conv_t: int  # number of leading steps with conv injection (int(0.8 * T))
    sites: Tuple[int, ...]  # injection site indices
    conv_block_key: str = "up_1_resnet_1"


class PnPControl(BaseControl):
    def __init__(self, spec: PnPSpec):
        self.spec = spec

    def qkv_hook(self, site: AttnSite, q, k, v, tensors, state, step):
        s = self.spec
        if site.is_cross or site.index not in s.sites or step >= s.qk_t:
            return q, k, v
        return lead_rows(q, ROWS), lead_rows(k, ROWS), v

    def resnet_hook(self, block_key, hidden, tensors, state, step):
        s = self.spec
        if block_key != s.conv_block_key or step >= s.conv_t:
            return hidden
        return lead_rows(hidden, ROWS)


def make_pnp_control(config: UNetConfig, num_steps: int = 50, pnp_f_t: float = 0.8,
                     pnp_attn_t: float = 0.5) -> PnPControl:
    return PnPControl(PnPSpec(qk_t=int(num_steps * pnp_attn_t), conv_t=int(num_steps * pnp_f_t),
                              sites=pnp_injection_sites(config)))
