"""P2P guidance sampling loops (port of ``pnpinversion_tpu/sampling/p2p_forward.py``:
``guidance_forward`` and ``fused_direct_inversion_edit_srcfree``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from pnpinversion_tpu_torch.control.base import NO_CONTROL, BaseControl
from pnpinversion_tpu_torch.models.unet import UNet
from pnpinversion_tpu_torch.schedulers.ddim import (
    DDIMSchedule,
    classifier_free_guidance,
    ddim_step,
)


def guidance_forward(
    unet: UNet,
    schedule: DDIMSchedule,
    latent: torch.Tensor,  # (1, h, w, c) or (B, h, w, c) start latent x_T
    cond_embeddings: torch.Tensor,  # (B, 77, D)
    uncond_embeddings: torch.Tensor,  # (B, 77, D) or per-step (T, 1|B, 77, D)
    guidance_scale: float,
    control: BaseControl = NO_CONTROL,
    tensors: Optional[Dict[str, torch.Tensor]] = None,
    noise_loss: Optional[torch.Tensor] = None,  # (T, B, h, w, c) offsets
    offset_row_mask: Optional[torch.Tensor] = None,  # (B,) 1.0 where offsets apply
) -> torch.Tensor:
    """CFG denoising at 2B UNet rows [uncond x B, cond x B] with attention
    control and optional per-step offsets (added only where both
    ``noise_loss`` and ``offset_row_mask`` are given). Returns the final
    latents (B, h, w, c)."""
    T = schedule.num_steps
    B = cond_embeddings.shape[0]
    latents = latent.expand((B,) + latent.shape[1:])
    per_step_uncond = uncond_embeddings.dim() == 4
    state = control.init_state(B, heads=unet.config.num_heads, device=latents.device)
    for i in range(T):
        t = schedule.timesteps[i]
        unc = uncond_embeddings[i].expand_as(cond_embeddings) if per_step_uncond \
            else uncond_embeddings
        eps2, state = unet(torch.cat([latents, latents], dim=0), t,
                           torch.cat([unc, cond_embeddings], dim=0), control, tensors, state,
                           step=i)
        eps = classifier_free_guidance(eps2[:B], eps2[B:], guidance_scale)
        latents = ddim_step(schedule, eps, t, latents)
        if noise_loss is not None and offset_row_mask is not None:
            latents = latents + noise_loss[i] * offset_row_mask[:, None, None, None]
        latents, state = control.step_callback(latents, tensors, state, i)
    return latents


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
