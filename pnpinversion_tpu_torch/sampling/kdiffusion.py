"""k-diffusion-style sampling in sigma space (Euler ancestral) for the
instruction-editing models (port of
``pnpinversion_tpu/sampling/kdiffusion.py``).

The sigma grid is log-interpolated over the 1000-step table
sqrt((1 - acp) / acp); the denoiser is x - sigma * eps(x / sqrt(1 + sigma^2),
t(sigma)) with a continuous timestep t(sigma). Sigmas, timesteps and step
sizes are host scalars computed in f32, as the JAX package computes them
(x64 off); the latents are f32.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from pnpinversion_tpu_torch.schedulers.ddim import DDIMSchedule
from pnpinversion_tpu_torch.utils.observability import spanned

F32 = np.float32


def sigma_table(schedule: DDIMSchedule) -> np.ndarray:
    acp = schedule.alphas_cumprod
    return np.sqrt((F32(1.0) - acp) / acp).astype(F32)


def get_sigmas(schedule: DDIMSchedule, n: int) -> np.ndarray:
    """n + 1 descending f32 sigmas, the last 0 (k-diffusion's
    ``DiscreteSchedule.get_sigmas``)."""
    log_sig = np.log(sigma_table(schedule))
    t = np.linspace(0.0, schedule.num_train_timesteps - 1, n, dtype=F32)
    low = np.floor(t).astype(np.int64)
    high = np.ceil(t).astype(np.int64)
    w = t - low.astype(F32)
    sigmas = np.exp((F32(1.0) - w) * log_sig[low] + w * log_sig[high])[::-1]
    return np.concatenate([sigmas, np.zeros(1, F32)]).astype(F32)


def sigma_to_t(schedule: DDIMSchedule, sigma) -> float:
    """The continuous timestep of ``sigma``, by log-sigma interpolation
    (k-diffusion's ``CompVisDenoiser``)."""
    log_sig = np.log(sigma_table(schedule))
    ls = np.log(F32(sigma))
    low_idx = int(np.clip(np.sum(ls - log_sig >= 0) - 1, 0, log_sig.shape[0] - 2))
    low, high = log_sig[low_idx], log_sig[low_idx + 1]
    w = np.clip((low - ls) / (low - high), F32(0.0), F32(1.0))
    return float((F32(1.0) - w) * F32(low_idx) + w * F32(low_idx + 1))


def get_ancestral_step(sigma_from, sigma_to) -> Tuple[float, float]:
    """(sigma_down, sigma_up) of an ancestral step, in f32."""
    sf, st = F32(sigma_from), F32(sigma_to)
    sigma_up = min(st, np.sqrt(st * st * (sf * sf - st * st) / (sf * sf), dtype=F32))
    sigma_down = np.sqrt(st * st - sigma_up * sigma_up, dtype=F32)
    return float(sigma_down), float(sigma_up)


@spanned("pnpi.edit.sample")
def sample_euler_ancestral(denoise_fn: Callable[[torch.Tensor, float], torch.Tensor],
                           x: torch.Tensor, sigmas: np.ndarray,
                           noise_fn: Callable[[], torch.Tensor]) -> torch.Tensor:
    """Euler-ancestral sampling over ``sigmas`` (n + 1,): ``denoise_fn(x,
    sigma)`` gives the denoised x0; ``noise_fn()`` one standard normal draw
    of x's shape (or one that broadcasts to it) per step."""
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        denoised = denoise_fn(x, sigma)
        sigma_down, sigma_up = get_ancestral_step(sigma, sigma_next)
        d = (x - denoised) / sigma
        x = x + d * float(F32(sigma_down) - F32(sigma))
        x = x + noise_fn() * (sigma_up if sigma_next > 0 else 0.0)
    return x
