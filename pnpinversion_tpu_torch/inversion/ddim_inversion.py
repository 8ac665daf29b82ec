"""DDIM inversion (port of
``pnpinversion_tpu/inversion/ddim_inversion.py::ddim_invert_loop``)."""
from __future__ import annotations

import torch

from pnpinversion_tpu_torch.models.unet import UNet
from pnpinversion_tpu_torch.schedulers.ddim import DDIMSchedule, ddim_inverse_step


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
