"""EDICT's exact affine DDIM steps and its coupled mixing layers, in f32
(port of ``pnpinversion_tpu/schedulers/edict.py``).

The step scalars come from the schedule's f32 tables on the host, computed in
f32 as the JAX package computes them. A latent pair is one tensor with the
pair on axis 1, (N, 2, ...): each of N images carries its two coupled
latents.
"""
from __future__ import annotations

import numpy as np
import torch

from pnpinversion_tpu_torch.schedulers.ddim import DDIMSchedule, _sqrt


def _step_scalars(schedule: DDIMSchedule, t: int):
    """(q, sqrt(beta_t), sqrt(1 - alpha_prev)) in f32, q = sqrt(alpha_t /
    alpha_prev), alpha_prev at t - step_ratio (the final alpha below 0)."""
    alpha_t = schedule.alpha_at(t)
    alpha_prev = schedule.alpha_at(t - schedule.step_ratio)
    one = np.float32(1.0)
    return _sqrt(alpha_t / alpha_prev), _sqrt(one - alpha_t), _sqrt(one - alpha_prev)


def edict_forward_step(schedule: DDIMSchedule, eps: torch.Tensor, t: int,
                       sample: torch.Tensor) -> torch.Tensor:
    """Generation-direction step x_t -> x_{t - step_ratio}, in quotient form."""
    q, sb, sp = _step_scalars(schedule, t)
    q, sb, sp = float(q), float(sb), float(sp)
    return sample / q - sb * eps / q + sp * eps


def edict_reverse_step(schedule: DDIMSchedule, eps: torch.Tensor, t: int,
                       sample: torch.Tensor) -> torch.Tensor:
    """The exact inverse of ``edict_forward_step``."""
    q, sb, sp = _step_scalars(schedule, t)
    return float(q) * sample + float(sb) * eps - float(q * sp) * eps


def edict_mix(pair: torch.Tensor, mix_weight: float) -> torch.Tensor:
    """Generation-direction contraction of a pair (N, 2, ...)."""
    p = mix_weight
    x0 = p * pair[:, 0] + (1.0 - p) * pair[:, 1]
    x1 = (1.0 - p) * x0 + p * pair[:, 1]
    return torch.stack([x0, x1], dim=1)


def edict_unmix(pair: torch.Tensor, mix_weight: float) -> torch.Tensor:
    """The exact inverse of ``edict_mix``, applied before inversion steps."""
    p = mix_weight
    x1 = (pair[:, 1] - (1.0 - p) * pair[:, 0]) / p
    x0 = (pair[:, 0] - (1.0 - p) * x1) / p
    return torch.stack([x0, x1], dim=1)
