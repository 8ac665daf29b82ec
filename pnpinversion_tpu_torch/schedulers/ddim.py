"""DDIM scheduler math (port of ``pnpinversion_tpu/schedulers/ddim.py``).

The tables live on the host as f32 numpy arrays and timesteps are Python
ints, so each step reads its alphas without touching the device. As in the
JAX package, every alpha-derived scalar is rounded to the sample's dtype
before it multiplies the sample (that matters in bf16).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """alphas_cumprod: (num_train_timesteps,) f32; final_alpha_cumprod: used
    when the previous timestep is < 0; timesteps: descending ints, e.g.
    [980, 960, ..., 0] for 50 steps."""

    alphas_cumprod: np.ndarray
    final_alpha_cumprod: np.float32
    timesteps: tuple
    num_train_timesteps: int
    num_steps: int

    @property
    def step_ratio(self) -> int:
        return self.num_train_timesteps // self.num_steps

    def alpha_at(self, t: int) -> np.float32:
        return self.alphas_cumprod[t] if t >= 0 else self.final_alpha_cumprod


def make_ddim_schedule(num_steps: int = 50, num_train_timesteps: int = 1000,
                       beta_start: float = 0.00085, beta_end: float = 0.012,
                       set_alpha_to_one: bool = False, steps_offset: int = 0) -> DDIMSchedule:
    """diffusers DDIMScheduler as SD1.4 configures it (scaled_linear betas)."""
    betas = (np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                         dtype=np.float64) ** 2).astype(np.float32)
    alphas_cumprod = np.cumprod(1.0 - betas.astype(np.float64)).astype(np.float32)
    final_alpha = np.float32(1.0) if set_alpha_to_one else alphas_cumprod[0]
    step_ratio = num_train_timesteps // num_steps
    timesteps = (np.arange(0, num_steps) * step_ratio).round()[::-1].astype(np.int64)
    return DDIMSchedule(alphas_cumprod=alphas_cumprod, final_alpha_cumprod=final_alpha,
                        timesteps=tuple(int(t) + steps_offset for t in timesteps),
                        num_train_timesteps=num_train_timesteps, num_steps=num_steps)


def _scalar(value, like: torch.Tensor) -> float:
    """An f32 host scalar rounded to ``like``'s dtype."""
    return torch.tensor(float(np.float32(value)), dtype=like.dtype).item()


def _sqrt(x) -> np.float32:
    return np.sqrt(np.float32(x), dtype=np.float32)


def pred_x0_from_eps(sample: torch.Tensor, eps: torch.Tensor, alpha_prod_t) -> torch.Tensor:
    beta_prod_t = np.float32(1.0) - alpha_prod_t
    return (sample - _scalar(_sqrt(beta_prod_t), sample) * eps) / _scalar(
        _sqrt(alpha_prod_t), sample)


def ddim_step(schedule: DDIMSchedule, eps: torch.Tensor, t: int,
              sample: torch.Tensor) -> torch.Tensor:
    """x_t -> x_{t - step_ratio} (deterministic DDIM, eta = 0)."""
    alpha_prod_t = schedule.alpha_at(t)
    alpha_prod_t_prev = schedule.alpha_at(t - schedule.step_ratio)
    pred_x0 = pred_x0_from_eps(sample, eps, alpha_prod_t)
    direction = _scalar(_sqrt(np.float32(1.0) - alpha_prod_t_prev), sample) * eps
    return _scalar(_sqrt(alpha_prod_t_prev), sample) * pred_x0 + direction


def ddim_inverse_step(schedule: DDIMSchedule, eps: torch.Tensor, t: int,
                      sample: torch.Tensor) -> torch.Tensor:
    """x_t -> x_{t + step_ratio} (DDIM inversion): the current alpha is taken
    at min(t - step_ratio, 999), the next at t."""
    cur_t = min(t - schedule.step_ratio, schedule.num_train_timesteps - 1)
    alpha_prod_t = schedule.alpha_at(cur_t)
    alpha_prod_t_next = schedule.alpha_at(t)
    x0 = pred_x0_from_eps(sample, eps, alpha_prod_t)
    direction = _scalar(_sqrt(np.float32(1.0) - alpha_prod_t_next), sample) * eps
    return _scalar(_sqrt(alpha_prod_t_next), sample) * x0 + direction


def classifier_free_guidance(eps_uncond: torch.Tensor, eps_cond: torch.Tensor,
                             scale: float) -> torch.Tensor:
    return eps_uncond + _scalar(scale, eps_cond) * (eps_cond - eps_uncond)
