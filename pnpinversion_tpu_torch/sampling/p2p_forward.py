"""The source-free fused DirectInversion + P2P edit scan (port of
``pnpinversion_tpu/sampling/p2p_forward.py::fused_direct_inversion_edit_srcfree``)."""
from __future__ import annotations

from typing import Dict

import torch

from pnpinversion_tpu_torch.control.base import BaseControl
from pnpinversion_tpu_torch.models.unet import UNet
from pnpinversion_tpu_torch.schedulers.ddim import (
    DDIMSchedule,
    classifier_free_guidance,
    ddim_step,
)


def fused_direct_inversion_edit_srcfree(
    unet: UNet,
    schedule: DDIMSchedule,
    trajectory: torch.Tensor,  # (T+1, 1, h, w, c) inversion trajectory
    cond_embeddings: torch.Tensor,  # (B, 77, D)
    uncond_embeddings: torch.Tensor,  # (B, 77, D)
    guidance_scale: float,
    control: BaseControl,
    tensors: Dict[str, torch.Tensor],
) -> torch.Tensor:
    """Full-offset DirectInversion edit in a (2B-1)-row loop.

    With full offsets the source row re-snaps to the inversion trajectory
    every step (latents[0] == trajectory[T-1-i]), so the uncond-source UNet
    row is dead compute and is dropped. Batch layout: [uncond x (B-1),
    cond x B]; ``control`` must use a spec with ``uncond_rows = B - 1``.
    Returns the final latents (B, h, w, c).
    """
    T = schedule.num_steps
    B = cond_embeddings.shape[0]
    latents = trajectory[-1].expand((B,) + trajectory.shape[2:])
    ctx = torch.cat([uncond_embeddings[1:], cond_embeddings], dim=0)
    state = control.init_state(B, heads=unet.config.num_heads, device=latents.device)
    for i in range(T):
        t = schedule.timesteps[i]
        eps2, state = unet(torch.cat([latents[1:], latents], dim=0), t, ctx, control,
                           tensors, state, step=i)
        eps_t = classifier_free_guidance(eps2[: B - 1], eps2[B:], guidance_scale)
        stepped_t = ddim_step(schedule, eps_t, t, latents[1:])
        latents = torch.cat([trajectory[T - 1 - i], stepped_t], dim=0)
        latents, state = control.step_callback(latents, tensors, state, i)
    return latents
