"""pix2pix-zero: the noise-regularised inversion and the cross-attention
guided edit (port of ``pnpinversion_tpu/inversion/pix2pix_zero.py``).

- ``p2z_invert``: per step, eps from the caption-conditioned UNet, then
  ``regularize_noise`` (5 rounds of 5 autocorrelation-gradient steps and one
  KL-gradient step on eps), then the inverse DDIM step of pix2pix-zero's
  inverse scheduler (alphas at t - 1, the end clamped to the last train
  step), computed in f32 and cast back to the latent's dtype.
- ``p2z_edit``: one loop of T steps doing both passes: the reconstruction
  step records the reference cross-attention maps, then the edit latent
  takes one SGD step toward them (the gradient of the map loss through the
  whole UNet), and steps with the edit direction added to the cond row.

Like the other loops of the port, every function takes N images (a leading
image axis; the rows of a UNet call image-major). The autocorrelation rolls
are one table of host ints per edit (``draw_shifts``: from a CPU
``torch.Generator``, where the JAX package draws them with
``jax.random.randint``), shared by a batch's images as the JAX batched class
shares its key.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pnpinversion_tpu_torch.control.attn_store import CrossAttnStoreControl
from pnpinversion_tpu_torch.models.unet import UNet, apply_images
from pnpinversion_tpu_torch.schedulers.ddim import (
    DDIMSchedule,
    _sqrt,
    classifier_free_guidance,
    ddim_step,
)

NUM_REG_STEPS = 5
NUM_AC_ROLLS = 5


def roll_highs(size: int) -> List[int]:
    """The exclusive upper bound of each pyramid level's roll: one level per
    halving of ``size`` down to 8, max(1, level size // 2) each."""
    levels, s = 1, size
    while s > 8:
        s //= 2
        levels += 1
    return [max(1, (size >> i) // 2) for i in range(levels)]


def draw_shifts(generator: torch.Generator, size: int, num_steps: int,
                num_reg_steps: int = NUM_REG_STEPS,
                num_ac_rolls: int = NUM_AC_ROLLS) -> np.ndarray:
    """The rolls of a whole inversion, (num_steps, num_reg_steps,
    num_ac_rolls, levels) int64, level l's uniform in [0, roll_highs[l]),
    from a CPU generator."""
    shape = (num_steps, num_reg_steps, num_ac_rolls)
    return np.stack([torch.randint(0, m, shape, generator=generator).numpy()
                     for m in roll_highs(size)], axis=-1)


def auto_corr_loss(x: torch.Tensor, shifts: Sequence[int]) -> torch.Tensor:
    """The pyramid autocorrelation loss of each image: x (N, H, W, C);
    shifts (levels,) ints, each level's roll on both axes. Returns (N,) f32."""
    n, h, w, c = x.shape
    noise = x.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)  # per-channel maps
    loss = torch.zeros((n,), dtype=torch.float32, device=x.device)
    for roll in shifts:
        roll = int(roll)
        for dim in (2, 3):
            m = torch.mean(noise * torch.roll(noise, roll, dims=dim), dim=(1, 2, 3))
            loss = loss + (m * m).view(n, c).sum(dim=1).float()
        if noise.shape[2] > 8:
            noise = F.avg_pool2d(noise, 2)
    return loss


def kl_divergence(x: torch.Tensor) -> torch.Tensor:
    """Each image's KL term var + mu^2 - 1 - log(var + 1e-7), over all of
    its values: x (N, ...) -> (N,)."""
    flat = x.reshape(x.shape[0], -1)
    mu = flat.mean(dim=1)
    var = flat.var(dim=1, unbiased=False)
    return var + mu * mu - 1.0 - torch.log(var + 1e-7)


def _grad(fn, x: torch.Tensor) -> torch.Tensor:
    """d(sum over images of fn(x)) / dx: each image's own loss gradient."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(x).sum(), x)
    return g


def regularize_noise(eps: torch.Tensor, shifts: np.ndarray, lambda_ac: float = 20.0,
                     lambda_kl: float = 20.0) -> torch.Tensor:
    """eps (N, H, W, C); shifts (num_reg_steps, num_ac_rolls, levels). Each
    round: num_ac_rolls steps of -lambda_ac / num_ac_rolls times the
    autocorrelation gradient, then one of -lambda_kl times the KL gradient."""
    num_ac_rolls = shifts.shape[1]
    for round_shifts in shifts:
        for s in round_shifts:
            g = _grad(lambda z, s=s: auto_corr_loss(z, s), eps)
            eps = eps - lambda_ac * g / num_ac_rolls
        eps = eps - lambda_kl * _grad(kl_divergence, eps)
    return eps


def p2z_inverse_step(schedule: DDIMSchedule, eps: torch.Tensor, t: int,
                     sample: torch.Tensor) -> torch.Tensor:
    """x_t -> x_{t + step_ratio} with the alphas at t - 1 and at the next t
    - 1 (the last train step's past the end), in f32 (the JAX package's f32
    schedule scalars promote bf16 inputs); returns f32."""
    n_train = schedule.num_train_timesteps
    alphas = schedule.alphas_cumprod
    a_t = alphas[min(max(t - 1, 0), n_train - 1)]
    prev_t = t + schedule.step_ratio
    a_prev = alphas[min(max(prev_t - 1, 0), n_train - 1)] if prev_t <= n_train else alphas[-1]
    one = np.float32(1.0)
    eps, sample = eps.float(), sample.float()
    x0 = (sample - float(_sqrt(one - a_t)) * eps) / float(_sqrt(a_t))
    return float(_sqrt(a_prev)) * x0 + float(_sqrt(one - a_prev)) * eps


def p2z_invert(unet: UNet, schedule: DDIMSchedule, latent: torch.Tensor,
               cond_embedding: torch.Tensor, shifts: np.ndarray, lambda_ac: float = 20.0,
               lambda_kl: float = 20.0) -> torch.Tensor:
    """latent (N, 1, h, w, c), the posterior-sampled latents; cond_embedding
    (N, 1, 77, D), the captions'; shifts (T, num_reg_steps, num_ac_rolls,
    levels) from ``draw_shifts``. Walks the timesteps upward (the
    steps_offset=1 schedule's [1, 21, ..., 981] at 50 steps); returns the
    trajectory (N, T+1, 1, h, w, c) in the latent's dtype."""
    T = schedule.num_steps
    traj = [latent]
    for i in range(T):
        t = schedule.timesteps[T - 1 - i]
        lat = traj[-1]
        eps, _ = apply_images(unet, lat, t, cond_embedding)
        eps = regularize_noise(eps[:, 0], shifts[i], lambda_ac, lambda_kl)[:, None]
        traj.append(p2z_inverse_step(schedule, eps, t, lat).to(latent.dtype))
    return torch.stack(traj, dim=1)


def _map_loss(curr: dict, ref: dict, rows: int) -> torch.Tensor:
    """Sum over images of each image's sum over sites (in the JAX package's
    sorted key order) of mean over its rows and heads of the per-map
    squared distance summed over (Sq, 77), in f32."""
    total = None
    for k in sorted(ref):
        d = (curr[k].float() - ref[k].detach().float()) ** 2
        d = d.view((-1, rows) + d.shape[1:]).sum(dim=(3, 4)).mean(dim=(1, 2))
        total = d if total is None else total + d
    return total.sum()


def p2z_edit(unet: UNet, schedule: DDIMSchedule, x_inv: torch.Tensor,
             prompt_embeds: torch.Tensor, edit_dir: torch.Tensor, guidance_scale: float,
             guidance_amount: float, latent_list: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_inv (N, 1, h, w, c), the inversion's endpoint; prompt_embeds
    (N, 2, 77, D) = [negative (the caption), caption]; edit_dir (N, 1, 77, D),
    added to the cond row in the edit pass; latent_list (N, T+1, 1, h, w, c),
    the trajectory, for directinversion's offsets (None for ddim+). Per step
    three UNet calls of 2 rows: the reconstruction (recording the reference
    maps, detached), the map loss's forward and backward with respect to the
    edit latent, and the edit step from the uncond half of the moved
    latent. Returns (recon, edit) latents, each (N, 1, h, w, c)."""
    T = schedule.num_steps
    store = CrossAttnStoreControl()
    embeds_edit = prompt_embeds.clone()
    embeds_edit[:, 1:2] += edit_dir
    rec = edit = x_inv
    for i in range(T):
        t = schedule.timesteps[i]
        eps2, ref = apply_images(unet, torch.cat([rec, rec], dim=1), t, prompt_embeds, store,
                                 {}, {}, i)
        rec_new = ddim_step(schedule, classifier_free_guidance(eps2[:, :1], eps2[:, 1:],
                                                               guidance_scale), t, rec)
        if latent_list is not None:
            noise_loss = latent_list[:, T - 1 - i] - rec_new
            rec_new = rec_new + noise_loss
        else:
            noise_loss = torch.zeros_like(rec_new)

        def loss_fn(x):
            _, cur = apply_images(unet, x, t, embeds_edit, store, {}, {}, i)
            return _map_loss(cur, ref, 2)

        x_in = torch.cat([edit, edit], dim=1)
        x_in = x_in - guidance_amount * _grad(loss_fn, x_in)
        eps2e, _ = apply_images(unet, x_in, t, embeds_edit)
        eps_e = classifier_free_guidance(eps2e[:, :1], eps2e[:, 1:], guidance_scale)
        edit = ddim_step(schedule, eps_e, t, x_in[:, :1]) + noise_loss
        rec = rec_new
    return rec, edit
