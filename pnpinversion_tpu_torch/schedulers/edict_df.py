"""EDICT's latent algebra in float64 (the port's counterpart of
``pnpinversion_tpu/schedulers/edict_df.py``).

The reference casts the whole EDICT pipeline to float64 for exact
invertibility. The JAX package emulates that carry on the TPU with
double-float pairs of f32 words; the card has fast float64 for elementwise
work, so here the coupled latents are a native ``torch.float64`` tensor and
the UNet still computes in f32 on the carry's f32 rounding. Every affine
update is ``x' = A*x + C*eps`` with A and C computed on the host in float64
from the float64 beta schedule, and the mixing layers take float64 constants.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def _alphas_cumprod_f64(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                        beta_end: float = 0.012) -> np.ndarray:
    betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def edict_df_coeffs(timesteps: Sequence[int], step_ratio: int, reverse: bool,
                    num_train_timesteps: int = 1000) -> Tuple[np.ndarray, np.ndarray]:
    """Per-step (A, C), float64, for x' = A*x + C*eps at each of a pass's
    ``timesteps`` in the pass's order (a schedule's timesteps[t_limit:],
    flipped when ``reverse``):

    forward (generation): A = 1/q, C = -sqrt(beta_t)/q + sqrt(1 - a_prev)
    reverse (inversion):  A = q,   C =  sqrt(beta_t)   - q sqrt(1 - a_prev)

    with q = sqrt(a_t / a_prev), a_prev at t - step_ratio (the final alpha,
    alphas_cumprod[0], below 0)."""
    ac = _alphas_cumprod_f64(num_train_timesteps)

    def alpha_at(t):
        return ac[t] if t >= 0 else ac[0]

    a_t = np.array([alpha_at(t) for t in timesteps])
    a_prev = np.array([alpha_at(t - step_ratio) for t in timesteps])
    q = np.sqrt(a_t / a_prev)
    if reverse:
        return q, np.sqrt(1.0 - a_t) - q * np.sqrt(1.0 - a_prev)
    return 1.0 / q, -np.sqrt(1.0 - a_t) / q + np.sqrt(1.0 - a_prev)


def _mix_consts(p: float) -> Dict[str, float]:
    """The mixing layers' float64 constants: p, 1 - p, 1/p, -(1 - p)/p."""
    p = float(np.float64(p))
    return {"p": p, "omp": 1.0 - p, "invp": 1.0 / p, "nompp": -(1.0 - p) / p}


def edict_step_f64(x: torch.Tensor, eps: torch.Tensor, a: float, c: float) -> torch.Tensor:
    """x' = A*x + C*eps, with the float64 carry x and the UNet's f32 eps."""
    return a * x + c * eps.double()


def edict_mix_f64(pair: torch.Tensor, mix_weight: float) -> torch.Tensor:
    """Generation-direction contraction of a float64 pair (N, 2, ...)."""
    c = _mix_consts(mix_weight)
    y0 = c["p"] * pair[:, 0] + c["omp"] * pair[:, 1]
    y1 = c["omp"] * y0 + c["p"] * pair[:, 1]
    return torch.stack([y0, y1], dim=1)


def edict_unmix_f64(pair: torch.Tensor, mix_weight: float) -> torch.Tensor:
    """The exact inverse of ``edict_mix_f64``."""
    c = _mix_consts(mix_weight)
    y1 = c["invp"] * pair[:, 1] + c["nompp"] * pair[:, 0]
    y0 = c["invp"] * pair[:, 0] + c["nompp"] * y1
    return torch.stack([y0, y1], dim=1)
