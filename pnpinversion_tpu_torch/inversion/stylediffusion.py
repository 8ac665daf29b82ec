"""StyleDiffusion's inversion: DDIM inversion recording the 16^2 cross maps,
then per-step training of the mapping networks (port of
``pnpinversion_tpu/inversion/stylediffusion.py``).

At step i the network warm-starts from step i - 1's, takes at most
ceil(num_inner_steps * e^(-0.1 i)) Adam steps (optax's ``adam(1.0)`` scaled
by lr = 1e-2 (1 - i/100), the port's null-text Adam) on the f32 latent MSE
plus cross-map MSE, stopping once the loss before an update falls below
1e-5 + 2e-5 i, then advances the latent with the trained network. The
gradient reaches the networks only; the UNet is frozen.

Every function takes N images (a leading image axis). Each image trains its
own networks against its own loss and stops on its own: an image whose loop
has ended keeps its network and Adam state while the others go on, as each
image's ``while_loop`` does under the JAX package's ``vmap``. The images'
rows share the UNet calls; their losses, statistics and stopping never mix.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from pnpinversion_tpu_torch.control.stylediffusion import StyleStoreControl, StyleTrainControl
from pnpinversion_tpu_torch.inversion.ddim_inversion import _adam_step, _schedule_lr_thr
from pnpinversion_tpu_torch.models.stylediffusion import Params
from pnpinversion_tpu_torch.models.unet import UNet, apply_images
from pnpinversion_tpu_torch.parallel import agreement
from pnpinversion_tpu_torch.schedulers.ddim import (
    DDIMSchedule,
    classifier_free_guidance,
    ddim_inverse_step,
    ddim_step,
)


def ddim_invert_with_maps(unet: UNet, schedule: DDIMSchedule, latent: torch.Tensor,
                          cond_embedding: torch.Tensor
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cond-only DDIM inversion of N images recording each step's 16^2 cross
    maps: latent (N, 1, h, w, c), cond_embedding (N, 1, 77, D). Returns (the
    trajectory (N, T+1, 1, h, w, c), {``sd_maps_<slot>``: (N, T, 1, H, 256,
    77) f32})."""
    T = schedule.num_steps
    store = StyleStoreControl()
    traj, maps = [latent], {}
    n = latent.shape[0]
    for i in range(T):
        t = schedule.timesteps[T - 1 - i]
        eps, st = apply_images(unet, traj[-1], t, cond_embedding, store, {}, {}, i)
        traj.append(ddim_inverse_step(schedule, eps, t, traj[-1]))
        for k, v in st.items():
            maps.setdefault(k, []).append(v.view((n, 1) + v.shape[1:]))
    return torch.stack(traj, dim=1), {k: torch.stack(v, dim=1) for k, v in sorted(maps.items())}


def inner_steps_schedule(num_steps: int, num_inner_steps: int) -> np.ndarray:
    """The most Adam steps of each outer step: ceil(K e^(-0.1 i))."""
    x = np.linspace(0, num_steps - 1, num_steps)
    return np.ceil(num_inner_steps * np.exp(-0.1 * x)).astype(np.int32)


def _losses(unet, schedule, latent, t, i, cond, eps_u, target, gt, img_tokens, mapper,
            guidance_scale, control) -> torch.Tensor:
    """Each image's f32 latent MSE plus its cross-map MSEs (the maps in
    slot order), (N,)."""
    n = latent.shape[0]
    eps_c, st = apply_images(unet, latent, t, cond, control,
                             {"sd_mapper_i": mapper, "img_tokens": img_tokens}, {}, i)
    rec = ddim_step(schedule, classifier_free_guidance(eps_u, eps_c, guidance_scale), t, latent)
    d = (rec - target).float()
    attn = torch.zeros((n,), dtype=torch.float32, device=latent.device)
    for k, ref in gt.items():
        m = (st[k].float() - ref.reshape(st[k].shape).float()) ** 2
        attn = attn + m.view(n, -1).mean(dim=1)
    return (d * d).view(n, -1).mean(dim=1) + attn


def train_mappers(unet: UNet, schedule: DDIMSchedule, trajectory: torch.Tensor,
                  gt_maps: Dict[str, torch.Tensor], img_tokens: torch.Tensor,
                  uncond_embedding: torch.Tensor, cond_embedding: torch.Tensor,
                  guidance_scale: float, mapper0: Params, num_inner_steps: int = 100,
                  epsilon: float = 1e-5) -> Params:
    """trajectory (N, T+1, 1, h, w, c) and gt_maps from
    ``ddim_invert_with_maps``; img_tokens (N, 197, width); the embeddings
    (N, 1, 77, D); mapper0 one step's networks (N, ...), the start. Returns
    the trained networks stacked over the steps, (N, T, ...).

    The gradient flows through the UNet, so this runs outside inference
    mode; only the inner loop records a graph."""
    T = schedule.num_steps
    n = trajectory.shape[0]
    inner = inner_steps_schedule(T, num_inner_steps)
    train_ctrl, adv_ctrl = StyleTrainControl("all"), StyleTrainControl("cond_half")
    latent_cur = trajectory[:, -1]
    mapper = {k: v.detach().clone() for k, v in mapper0.items()}
    ctx = torch.cat([uncond_embedding, cond_embedding], dim=1)
    stacked = []
    for i in range(T):
        t = schedule.timesteps[i]
        target = trajectory[:, T - 1 - i]
        gt_idx = min(T - i, T - 1)  # the inversion's maps at this timestep
        gt = {k: v[:, gt_idx] for k, v in gt_maps.items()}
        lr, thr = _schedule_lr_thr(i, epsilon)
        with torch.no_grad():
            eps_u, _ = apply_images(unet, latent_cur, t, uncond_embedding)
        mu = {k: torch.zeros_like(v) for k, v in mapper.items()}
        nu = {k: torch.zeros_like(v) for k, v in mapper.items()}
        active = torch.ones((n,), dtype=torch.bool, device=latent_cur.device)
        taken = 0
        for j in range(1, int(inner[i]) + 1):
            taken = j
            leaves = {k: v.detach().requires_grad_(True) for k, v in mapper.items()}
            with torch.enable_grad():
                loss = _losses(unet, schedule, latent_cur, t, i, cond_embedding, eps_u, target,
                               gt, img_tokens, leaves, guidance_scale, train_ctrl)
                grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
            agreement.losses("mapper_loss", loss)
            with torch.no_grad():
                for (k, v), g in zip(mapper.items(), grads):
                    new, m_new, v_new = _adam_step(v, g, mu[k], nu[k], j, lr)
                    keep = active.view((n,) + (1,) * (v.dim() - 1))
                    mapper[k], mu[k], nu[k] = (torch.where(keep, a, b) for a, b in
                                               ((new, v), (m_new, mu[k]), (v_new, nu[k])))
                active = active & (loss >= thr)
            if not active.any():
                break
        agreement.decision("mapper_inner_steps", taken)
        with torch.no_grad():
            eps2, _ = apply_images(unet, torch.cat([latent_cur, latent_cur], dim=1), t, ctx,
                                   adv_ctrl, {"sd_mapper_i": mapper, "img_tokens": img_tokens},
                                   {}, i)
            eps = classifier_free_guidance(eps2[:, :1], eps2[:, 1:], guidance_scale)
            latent_cur = ddim_step(schedule, eps, t, latent_cur)
        stacked.append(dict(mapper))
    return {k: torch.stack([m[k] for m in stacked], dim=1) for k in mapper}
