"""DDIM inversion, DirectInversion offsets, null-text optimisation and the
null-latent ablation (port of ``pnpinversion_tpu/inversion/ddim_inversion.py``).

Like the sampling loops, every function takes N images: each array argument
is the JAX package's one-image array with a leading image axis. The N images'
rows go through the UNet as one batch.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from pnpinversion_tpu_torch.models.unet import UNet, apply_images
from pnpinversion_tpu_torch.parallel import agreement
from pnpinversion_tpu_torch.schedulers.ddim import (
    DDIMSchedule,
    _scalar,
    classifier_free_guidance,
    ddim_inverse_step,
    ddim_step,
)
from pnpinversion_tpu_torch.utils.observability import spanned

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@spanned("pnpi.edit.invert")
def ddim_invert_loop(unet: UNet, schedule: DDIMSchedule, latent: torch.Tensor,
                     embedding: torch.Tensor) -> torch.Tensor:
    """Single-embedding DDIM inversion. latent (N, 1, h, w, c), embedding
    (N, 1, 77, D); returns (N, T+1, 1, h, w, c) with [:, 0] = the input
    latent and [:, -1] = the noised endpoint. Step i runs at
    timesteps[T-1-i]."""
    T = schedule.num_steps
    traj = [latent]
    for i in range(T):
        t = schedule.timesteps[T - 1 - i]
        eps, _ = apply_images(unet, traj[-1], t, embedding)
        traj.append(ddim_inverse_step(schedule, eps, t, traj[-1]))
    return torch.stack(traj, dim=1)


@spanned("pnpi.edit.invert")
def ddim_invert_loop_cfg(unet: UNet, schedule: DDIMSchedule, latent: torch.Tensor,
                         uncond_embedding: torch.Tensor, cond_embedding: torch.Tensor,
                         guidance_scale: float) -> torch.Tensor:
    """CFG-guided DDIM inversion (2 UNet rows per image); shapes as
    ``ddim_invert_loop``, embeddings (N, 1, 77, D) each."""
    T = schedule.num_steps
    ctx = torch.cat([uncond_embedding, cond_embedding], dim=1)
    traj = [latent]
    for i in range(T):
        t = schedule.timesteps[T - 1 - i]
        eps2, _ = apply_images(unet, torch.cat([traj[-1], traj[-1]], dim=1), t, ctx)
        eps = classifier_free_guidance(eps2[:, :1], eps2[:, 1:], guidance_scale)
        traj.append(ddim_inverse_step(schedule, eps, t, traj[-1]))
    return torch.stack(traj, dim=1)


def direct_inversion_offsets(unet: UNet, schedule: DDIMSchedule, traj: torch.Tensor,
                             ctx: torch.Tensor, guidance_scale: float,
                             step_gate: Optional[Sequence[float]] = None) -> tuple:
    """Replay the denoising with CFG from traj[:, -1] (N, T+1, 1, h, w, c)
    under the context (N, 2B, 77, D) = [uncond x B, cond x B], recording the
    offsets loss_i = (traj[:, T-1-i] - x̂_{t-1}) * step_gate[i] and adding
    them back. Returns (noise_loss (N, T, B, h, w, c), final latents
    (N, B, h, w, c))."""
    T = schedule.num_steps
    N, B = ctx.shape[0], ctx.shape[1] // 2
    gate = np.ones((T,), np.float32) if step_gate is None else step_gate
    latents = traj[:, -1].expand((N, B) + traj.shape[3:])
    losses = []
    for i in range(T):
        t = schedule.timesteps[i]
        eps2, _ = apply_images(unet, torch.cat([latents, latents], dim=1), t, ctx)
        eps = classifier_free_guidance(eps2[:, :B], eps2[:, B:], guidance_scale)
        prev_rec = ddim_step(schedule, eps, t, latents)
        loss = (traj[:, T - 1 - i] - prev_rec) * _scalar(gate[i], prev_rec)
        latents = prev_rec + loss
        losses.append(loss)
    return torch.stack(losses, dim=1), latents


def make_step_gate(num_steps: int, scale: float = 1.0, skip_step: int = 1) -> np.ndarray:
    """The per-step offset gate of the DirectInversion ablations: ``scale``
    on every ``skip_step``-th step from the first, 0 elsewhere (f32)."""
    gate = np.zeros((num_steps,), dtype=np.float32)
    gate[::skip_step] = scale
    return gate


def _adam_step(u: torch.Tensor, grad: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
               count: int, lr: float) -> tuple:
    """optax ``adam(1.0)`` followed by a scale of ``lr`` (the JAX package's
    update), in optax's order of operations: the moments as
    ``(1-b)*g**k + b*m`` with the constants and every product rounded to the
    leaf's dtype, the f32 bias corrections rounded to it, then
    ``u + (-update) * lr`` in f32 and rounded back. Returns (u, mu, nu)."""
    mu = _scalar(1.0 - ADAM_B1, grad) * grad + _scalar(ADAM_B1, mu) * mu
    nu = _scalar(1.0 - ADAM_B2, grad) * (grad * grad) + _scalar(ADAM_B2, nu) * nu
    one, n = np.float32(1.0), np.float32(count)
    mu_hat = mu / _scalar(one - np.float32(ADAM_B1) ** n, mu)
    nu_hat = nu / _scalar(one - np.float32(ADAM_B2) ** n, nu)
    update = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
    return (u.float() - update.float() * lr).to(u.dtype), mu, nu


def _schedule_lr_thr(i: int, epsilon: float) -> tuple:
    """Outer step i's Adam lr, 1e-2 (1 - i/100), and early-stop threshold,
    epsilon + 2e-5 i, in f32 as the JAX package computes them."""
    f32 = np.float32
    return (float(f32(1e-2) * (f32(1.0) - f32(i) / f32(100.0))),
            float(f32(epsilon) + f32(i) * f32(2e-5)))


def _optimise_uncond(unet: UNet, schedule: DDIMSchedule, latent: torch.Tensor, t: int,
                     uncond: torch.Tensor, eps_cond: torch.Tensor, target: torch.Tensor,
                     guidance_scale: float, num_inner_steps: int, lr: float,
                     thr: float) -> torch.Tensor:
    """At most ``num_inner_steps`` Adam steps (fresh state) on each image's
    uncond embedding (N, 1, 77, D), on the f32 MSE between the CFG DDIM step
    from ``latent`` (N, 1, h, w, c) and ``target``. Each image stops on its
    own: a step updates it first, then stops it once its loss (taken before
    the update) is below ``thr``; a stopped image keeps its embedding. The
    loss summed over images has each image's own MSE gradient, since the
    UNet treats its rows independently."""
    N = uncond.shape[0]
    mu, nu = torch.zeros_like(uncond), torch.zeros_like(uncond)
    active = torch.ones((N, 1, 1, 1), dtype=torch.bool, device=uncond.device)
    taken = 0
    for j in range(1, num_inner_steps + 1):
        taken = j
        u = uncond.detach().requires_grad_(True)
        with torch.enable_grad():
            eps_uncond, _ = apply_images(unet, latent, t, u)
            eps = classifier_free_guidance(eps_uncond, eps_cond, guidance_scale)
            d = (ddim_step(schedule, eps, t, latent) - target).float()
            loss = (d * d).reshape(N, -1).mean(dim=1)
            (grad,) = torch.autograd.grad(loss.sum(), u)
        agreement.losses("uncond_loss", loss)
        with torch.no_grad():
            u_new, mu_new, nu_new = _adam_step(uncond, grad, mu, nu, j, lr)
            uncond, mu, nu = (torch.where(active, a, b) for a, b in
                              ((u_new, uncond), (mu_new, mu), (nu_new, nu)))
            active = active & (loss >= thr).view(N, 1, 1, 1)
        if not active.any():
            break
    agreement.decision("uncond_inner_steps", taken)
    return uncond


def null_text_optimization(unet: UNet, schedule: DDIMSchedule, traj: torch.Tensor,
                           uncond: torch.Tensor, cond: torch.Tensor,
                           guidance_scale: float, num_inner_steps: int = 10,
                           epsilon: float = 1e-5) -> torch.Tensor:
    """Per-step Adam on the uncond embedding (null-text inversion).

    traj (N, T+1, 1, h, w, c) from ``ddim_invert_loop``; uncond/cond
    embeddings (N, 1, 77, D). At outer step i a fresh Adam state takes at most
    ``num_inner_steps`` steps of lr = 1e-2 (1 - i/100) on the f32 MSE between
    the CFG DDIM step and traj[:, T-1-i]; each step updates first and then
    stops early once its loss (taken before the update) is below
    epsilon + 2e-5 i, for each image on its own. The latent then advances
    with the optimised embedding. Returns the per-step embeddings
    (N, T, 1, 77, D).

    The gradient flows through the UNet, so this runs outside inference mode;
    only the inner loop records a graph.
    """
    T = schedule.num_steps
    latent_cur = traj[:, -1]
    uncond = uncond.detach().clone()
    out = []
    for i in range(T):
        t = schedule.timesteps[i]
        with torch.no_grad():
            eps_cond, _ = apply_images(unet, latent_cur, t, cond)
        lr, thr = _schedule_lr_thr(i, epsilon)
        uncond = _optimise_uncond(unet, schedule, latent_cur, t, uncond, eps_cond,
                                  traj[:, T - 1 - i], guidance_scale, num_inner_steps, lr, thr)
        with torch.no_grad():
            eps_uncond, _ = apply_images(unet, latent_cur, t, uncond)
            eps = classifier_free_guidance(eps_uncond, eps_cond, guidance_scale)
            latent_cur = ddim_step(schedule, eps, t, latent_cur)
        out.append(uncond)
    return torch.stack(out, dim=1)


def null_latent_offsets(unet: UNet, schedule: DDIMSchedule, traj: torch.Tensor,
                        ctx: torch.Tensor, guidance_scale: float, num_inner_steps: int = 10,
                        epsilon: float = 1e-5) -> torch.Tensor:
    """The null-latent ablation: optimise the uncond embedding per step as
    null-text does, and record the offset between the step with the
    optimised embedding and the plain-CFG step with the original one.
    traj (N, T+1, 1, h, w, c), ctx (N, 2B, 77, D) = [uncond x B,
    cond x B]; returns the offsets (N, T, B, h, w, c).

    The JAX package optimises all B uncond rows against a loss that reads
    only row 0, so rows 1+ get an exactly zero gradient, an exactly zero Adam
    update and exactly zero offsets, and their latents feed nothing but
    themselves. Here only row 0 runs (its cond row, the inner Adam loop, and
    one UNet call of two rows: the original uncond and the optimised one);
    the offsets of rows 1+ are zeros.
    """
    T = schedule.num_steps
    B = ctx.shape[1] // 2
    uncond0, cond0 = ctx[:, :1], ctx[:, B : B + 1]
    uncond = uncond0.detach().clone()
    latent_cur = traj[:, -1]  # (N, 1, h, w, c): row 0's latent
    losses = []
    for i in range(T):
        t = schedule.timesteps[i]
        with torch.no_grad():
            eps_cond, _ = apply_images(unet, latent_cur, t, cond0)
        lr, thr = _schedule_lr_thr(i, epsilon)
        uncond = _optimise_uncond(unet, schedule, latent_cur, t, uncond, eps_cond,
                                  traj[:, T - 1 - i], guidance_scale, num_inner_steps, lr, thr)
        with torch.no_grad():
            eps2, _ = apply_images(unet, torch.cat([latent_cur, latent_cur], dim=1), t,
                                   torch.cat([uncond0, uncond], dim=1))
            prev_rec, lat_opt = (
                ddim_step(schedule, classifier_free_guidance(e, eps_cond, guidance_scale), t,
                          latent_cur) for e in (eps2[:, :1], eps2[:, 1:]))
            loss = lat_opt - prev_rec
            latent_cur = prev_rec + loss
        losses.append(torch.cat([loss, torch.zeros_like(loss).expand(
            (-1, B - 1) + loss.shape[2:])], dim=1))
    return torch.stack(losses, dim=1)
