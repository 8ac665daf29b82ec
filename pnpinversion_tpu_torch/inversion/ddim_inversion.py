"""DDIM inversion and null-text optimisation (port of
``pnpinversion_tpu/inversion/ddim_inversion.py``: ``ddim_invert_loop`` and
``null_text_optimization``)."""
from __future__ import annotations

import numpy as np
import torch

from pnpinversion_tpu_torch.models.unet import UNet
from pnpinversion_tpu_torch.schedulers.ddim import (
    DDIMSchedule,
    _scalar,
    classifier_free_guidance,
    ddim_inverse_step,
    ddim_step,
)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def ddim_invert_loop(unet: UNet, schedule: DDIMSchedule, latent: torch.Tensor,
                     embedding: torch.Tensor) -> torch.Tensor:
    """Single-embedding DDIM inversion. latent (1, h, w, c); returns
    (T+1, 1, h, w, c) with [0] = the input latent and [-1] = the noised
    endpoint. Step i runs at timesteps[T-1-i]."""
    T = schedule.num_steps
    traj = [latent]
    for i in range(T):
        t = schedule.timesteps[T - 1 - i]
        eps, _ = unet(traj[-1], t, embedding)
        traj.append(ddim_inverse_step(schedule, eps, t, traj[-1]))
    return torch.stack(traj)


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


def null_text_optimization(unet: UNet, schedule: DDIMSchedule, trajectory: torch.Tensor,
                           uncond_embedding: torch.Tensor, cond_embedding: torch.Tensor,
                           guidance_scale: float, num_inner_steps: int = 10,
                           epsilon: float = 1e-5) -> torch.Tensor:
    """Per-step Adam on the uncond embedding (null-text inversion).

    trajectory (T+1, 1, h, w, c) from ``ddim_invert_loop``; uncond/cond
    embeddings (1, 77, D). At outer step i a fresh Adam state takes at most
    ``num_inner_steps`` steps of lr = 1e-2 (1 - i/100) on the f32 MSE between
    the CFG DDIM step and trajectory[T-1-i]; each step updates first and then
    stops early once its loss (taken before the update) is below
    epsilon + 2e-5 i. The latent then advances with the optimised embedding.
    Returns the per-step embeddings (T, 1, 77, D).

    The gradient flows through the UNet, so this runs outside inference mode;
    only the inner loop records a graph.
    """
    T = schedule.num_steps
    latent_cur = trajectory[-1]
    uncond = uncond_embedding.detach().clone()
    out = []
    for i in range(T):
        t = schedule.timesteps[i]
        latent_prev = trajectory[T - 1 - i]
        with torch.no_grad():
            eps_cond, _ = unet(latent_cur, t, cond_embedding)
        # lr and threshold in f32, as the JAX package computes them
        f32 = np.float32
        lr = float(f32(1e-2) * (f32(1.0) - f32(i) / f32(100.0)))
        thr = float(f32(epsilon) + f32(i) * f32(2e-5))
        mu, nu = torch.zeros_like(uncond), torch.zeros_like(uncond)
        for j in range(1, num_inner_steps + 1):
            u = uncond.detach().requires_grad_(True)
            with torch.enable_grad():
                eps_uncond, _ = unet(latent_cur, t, u)
                eps = classifier_free_guidance(eps_uncond, eps_cond, guidance_scale)
                d = (ddim_step(schedule, eps, t, latent_cur) - latent_prev).float()
                loss = (d * d).mean()
                (grad,) = torch.autograd.grad(loss, u)
            with torch.no_grad():
                uncond, mu, nu = _adam_step(uncond, grad, mu, nu, j, lr)
            if loss.item() < thr:
                break
        with torch.no_grad():
            eps_uncond, _ = unet(latent_cur, t, uncond)
            eps = classifier_free_guidance(eps_uncond, eps_cond, guidance_scale)
            latent_cur = ddim_step(schedule, eps, t, latent_cur)
        out.append(uncond)
    return torch.stack(out)
