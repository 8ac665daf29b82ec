"""P2P guidance sampling loops (port of ``pnpinversion_tpu/sampling/p2p_forward.py``).

Every loop takes N images: each array argument is the JAX package's
one-image array with a leading image axis (cond embeddings (N, B, 77, D),
latents (N, B, h, w, c), trajectories (N, T+1, 1, h, w, c), ...), and the
control's tensors are stacked over the images (``control.p2p.stack_tensors``).
The N images' rows go through the UNet as one batch, image-major
(``models.unet.apply_images``), where the JAX package ``vmap``s a one-image
loop; one image is N = 1. Guidance scales, row masks and step gates are
shared by the images.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from pnpinversion_tpu_torch.control.base import NO_CONTROL, BaseControl
from pnpinversion_tpu_torch.models.unet import UNet, apply_images
from pnpinversion_tpu_torch.schedulers.ddim import (
    DDIMSchedule,
    _scalar,
    classifier_free_guidance,
    ddim_step,
    ddim_step_recon_guided,
)
from pnpinversion_tpu_torch.utils.observability import spanned


def _start(control: BaseControl, unet: UNet, latent: torch.Tensor, N: int, B: int):
    """Start latents (N, B, h, w, c) from (N, 1|B, h, w, c), and the
    control's fresh state for N images of B prompts."""
    state = control.init_state(B, heads=unet.config.num_heads, device=latent.device, images=N)
    return latent.expand((N, B) + latent.shape[2:]), state


def _callback(control: BaseControl, latents: torch.Tensor, tensors, state, step: int):
    """The control's step callback on (N, B, h, w, c) latents, whose rows it
    sees as N*B image-major rows."""
    out, state = control.step_callback(latents.reshape((-1,) + latents.shape[2:]), tensors,
                                       state, step)
    return out.reshape(latents.shape), state


@spanned("pnpi.edit.sample")
def guidance_forward(
    unet: UNet,
    schedule: DDIMSchedule,
    latent: torch.Tensor,  # (N, 1|B, h, w, c) start latent x_T
    cond: torch.Tensor,  # (N, B, 77, D)
    uncond: torch.Tensor,  # (N, B, 77, D) or per-step (N, T, 1|B, 77, D)
    guidance_scale: float,
    control: BaseControl = NO_CONTROL,
    tensors: Optional[Dict[str, torch.Tensor]] = None,
    noise_loss: Optional[torch.Tensor] = None,  # (N, T, B, h, w, c) offsets
    offset_row_mask: Optional[torch.Tensor] = None,  # (B,) 1.0 where offsets apply
) -> torch.Tensor:
    """CFG denoising at 2B UNet rows per image [uncond x B, cond x B] with
    attention control and optional per-step offsets (added only where both
    ``noise_loss`` and ``offset_row_mask`` are given). Returns the final
    latents (N, B, h, w, c)."""
    N, B = cond.shape[:2]
    per_step_uncond = uncond.dim() == 5
    latents, state = _start(control, unet, latent, N, B)
    for i in range(schedule.num_steps):
        t = schedule.timesteps[i]
        unc = uncond[:, i].expand_as(cond) if per_step_uncond else uncond
        eps2, state = apply_images(unet, torch.cat([latents, latents], dim=1), t,
                                   torch.cat([unc, cond], dim=1), control, tensors, state, i)
        eps = classifier_free_guidance(eps2[:, :B], eps2[:, B:], guidance_scale)
        latents = ddim_step(schedule, eps, t, latents)
        if noise_loss is not None and offset_row_mask is not None:
            latents = latents + noise_loss[:, i] * offset_row_mask[..., None, None, None]
        latents, state = _callback(control, latents, tensors, state, i)
    return latents


@spanned("pnpi.edit.sample")
def fused_direct_inversion_edit(
    unet: UNet,
    schedule: DDIMSchedule,
    traj: torch.Tensor,  # (N, T+1, 1, h, w, c) inversion trajectory
    cond: torch.Tensor,  # (N, B, 77, D)
    uncond: torch.Tensor,  # (N, B, 77, D)
    guidance_scale: float,
    control: BaseControl,
    tensors: Dict[str, torch.Tensor],
    offset_row_mask: torch.Tensor,  # (B,)
    step_gate: Sequence[float],  # (T,)
) -> torch.Tensor:
    """DirectInversion offsets and the controlled edit in one 2B-row loop:
    the source row's own step gives the offset (traj[:, T-1-i] - its
    stepped latent, times ``step_gate[i]``), added to the rows of
    ``offset_row_mask``. With a zero row mask it is the plain CFG edit
    (ddim+p2p). ``control`` uses the plain spec. Returns the final latents
    (N, B, h, w, c)."""
    T = schedule.num_steps
    N, B = cond.shape[:2]
    latents, state = _start(control, unet, traj[:, -1], N, B)
    ctx = torch.cat([uncond, cond], dim=1)
    rm = offset_row_mask[..., None, None, None]
    for i in range(T):
        t = schedule.timesteps[i]
        eps2, state = apply_images(unet, torch.cat([latents, latents], dim=1), t, ctx, control,
                                   tensors, state, i)
        eps = classifier_free_guidance(eps2[:, :B], eps2[:, B:], guidance_scale)
        stepped = ddim_step(schedule, eps, t, latents)
        loss = (traj[:, T - 1 - i] - stepped[:, :1]) * _scalar(step_gate[i], stepped)
        latents = stepped + loss * rm
        latents, state = _callback(control, latents, tensors, state, i)
    return latents


@spanned("pnpi.edit.sample")
def fused_direct_inversion_edit_srcfree(
    unet: UNet,
    schedule: DDIMSchedule,
    traj: torch.Tensor,  # (N, T+1, 1, h, w, c) inversion trajectory
    cond: torch.Tensor,  # (N, B, 77, D)
    uncond: torch.Tensor,  # (N, B, 77, D)
    guidance_scale: float,
    control: BaseControl,
    tensors: Dict[str, torch.Tensor],
) -> torch.Tensor:
    """Full-offset DirectInversion edit in a (2B-1)-row loop per image.

    With full offsets the source row re-snaps to the inversion trajectory
    every step (latents[:, 0] == traj[:, T-1-i]), so the uncond-source UNet
    row is dead compute and is dropped. Rows per image: [uncond x (B-1),
    cond x B]; ``control`` must use a spec with ``uncond_rows = B - 1``.
    Returns the final latents (N, B, h, w, c).
    """
    T = schedule.num_steps
    N, B = cond.shape[:2]
    latents, state = _start(control, unet, traj[:, -1], N, B)
    ctx = torch.cat([uncond[:, 1:], cond], dim=1)
    for i in range(T):
        t = schedule.timesteps[i]
        eps2, state = apply_images(unet, torch.cat([latents[:, 1:], latents], dim=1), t, ctx,
                                   control, tensors, state, i)
        eps_t = classifier_free_guidance(eps2[:, : B - 1], eps2[:, B:], guidance_scale)
        stepped_t = ddim_step(schedule, eps_t, t, latents[:, 1:])
        latents = torch.cat([traj[:, T - 1 - i], stepped_t], dim=1)
        latents, state = _callback(control, latents, tensors, state, i)
    return latents


@spanned("pnpi.edit.sample")
def guidance_forward_single_branch(
    unet: UNet,
    schedule: DDIMSchedule,
    latent: torch.Tensor,  # (N, 1|B, h, w, c)
    cond: torch.Tensor,  # (N, B, 77, D)
    unc_steps: torch.Tensor,  # (N, T, 1, 77, D) optimised for row 0
    unc_static: torch.Tensor,  # (N, B, 77, D) plain "" embeddings for rows 1:
    guidance_scale: float,
    control: BaseControl = NO_CONTROL,
    tensors: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """The null-text ablation: the optimised uncond on the source row only,
    the plain one on the other rows. Returns the final latents (N, B, h, w, c)."""
    N, B = cond.shape[:2]
    latents, state = _start(control, unet, latent, N, B)
    for i in range(schedule.num_steps):
        t = schedule.timesteps[i]
        unc = torch.cat([unc_steps[:, i], unc_static[:, 1:]], dim=1)
        eps2, state = apply_images(unet, torch.cat([latents, latents], dim=1), t,
                                   torch.cat([unc, cond], dim=1), control, tensors, state, i)
        eps = classifier_free_guidance(eps2[:, :B], eps2[:, B:], guidance_scale)
        latents = ddim_step(schedule, eps, t, latents)
        latents, state = _callback(control, latents, tensors, state, i)
    return latents


def _dilate(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary dilation of an NHWC mask (..., h, w, c): a (2r+1)^2 max
    window, stride 1, -inf padding (the JAX package's reduce_window SAME)."""
    lead, (h, w, c) = mask.shape[:-3], mask.shape[-3:]
    x = mask.reshape((-1, h, w, c)).permute(0, 3, 1, 2)
    x = F.max_pool2d(x, 2 * radius + 1, stride=1, padding=radius)
    return x.permute(0, 2, 3, 1).reshape(lead + (h, w, c))


@spanned("pnpi.edit.sample")
def proximal_guidance_forward(
    unet: UNet,
    schedule: DDIMSchedule,
    latent: torch.Tensor,  # (N, 1|B, h, w, c)
    cond: torch.Tensor,  # (N, B, 77, D)
    uncond: torch.Tensor,  # (N, B, 77, D) or per-step (N, T, 1, 77, D)
    guidance_scale: float,
    control: BaseControl = NO_CONTROL,
    tensors: Optional[Dict[str, torch.Tensor]] = None,
    edit_stage: bool = True,
    prox: Optional[str] = None,  # None | 'l1' | 'l0'
    quantile: float = 0.7,
    image_enc: Optional[torch.Tensor] = None,  # (N, 1, h, w, c) latent for recon guidance
    recon_lr: float = 0.1,
    recon_t: int = 400,
    inversion_guidance: bool = False,
    x_stars: Optional[torch.Tensor] = None,  # (N, T+1, 1, h, w, c)
    dilate_mask: int = 1,
) -> torch.Tensor:
    """ProxEdit sampling. In the edit stage with ``prox`` set, the CFG delta
    is shrunk (soft for l1, hard for l0) by a threshold: the ``quantile`` of
    |delta| over each image's whole (B, h, w, c) delta, in f32 and linearly
    interpolated, or -quantile when quantile <= 0. Where the shrunk delta
    stays above the threshold (dilated) is the edit region; outside it, and
    in the recon window (t < recon_t, or t > -recon_t for recon_t < 0), the
    step pulls pred_x0 toward ``image_enc`` and the next latent toward the
    inversion trajectory ``x_stars`` (with ``inversion_guidance``). Without
    ``prox`` or outside the edit stage it is plain CFG. Returns the final
    latents (N, B, h, w, c)."""
    T = schedule.num_steps
    N, B = cond.shape[:2]
    per_step_uncond = uncond.dim() == 5
    latents, state = _start(control, unet, latent, N, B)
    use_prox = edit_stage and prox is not None
    for i in range(T):
        t = schedule.timesteps[i]
        unc = uncond[:, i].expand_as(cond) if per_step_uncond else uncond
        eps2, state = apply_images(unet, torch.cat([latents, latents], dim=1), t,
                                   torch.cat([unc, cond], dim=1), control, tensors, state, i)
        eps_u, eps_c = eps2[:, :B], eps2[:, B:]
        if use_prox:
            delta = eps_c - eps_u
            if quantile > 0:
                thr = torch.quantile(delta.abs().reshape(N, -1).float(), quantile, dim=1)
            else:
                thr = torch.full((N,), -quantile, dtype=torch.float32, device=delta.device)
            thr = thr.to(delta.dtype).view(N, 1, 1, 1, 1)
            shrunk = delta - torch.clamp(delta, -thr, thr)
            if prox == "l1":
                shrunk = torch.where(shrunk > 0, shrunk - thr, shrunk)
                shrunk = torch.where(shrunk < 0, shrunk + thr, shrunk)
            in_window = t < recon_t if recon_t > 0 else t > -recon_t
            mask_edit = (shrunk.abs() > thr).to(latents.dtype)
            if dilate_mask > 0:
                mask_edit = _dilate(mask_edit, int(dilate_mask))
            recon_mask = (1.0 - mask_edit) * float(in_window)
            eps = eps_u + _scalar(guidance_scale, shrunk) * shrunk
            lat_next, _ = ddim_step_recon_guided(
                schedule, eps, t, latents, ref_image=image_enc,
                recon_lr=recon_lr if image_enc is not None else 0.0,
                recon_mask=recon_mask if image_enc is not None else None)
            if inversion_guidance and x_stars is not None:
                lat_next = lat_next - _scalar(recon_lr, lat_next) * (
                    lat_next - x_stars[:, T - 1 - i]) * recon_mask
            latents = lat_next
        else:
            eps = classifier_free_guidance(eps_u, eps_c, guidance_scale)
            latents = ddim_step(schedule, eps, t, latents)
        latents, state = _callback(control, latents, tensors, state, i)
    return latents
