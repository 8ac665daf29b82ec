"""Edit-friendly DDPM inversion: noise-map extraction and the reverse process
that re-injects the maps (port of ``pnpinversion_tpu/inversion/ef_ddpm.py``).

Every function takes N images, each array argument with a leading image
axis, and their rows go through the UNet as one batch (image-major).

Precision: the JAX package's schedule tables are f32 arrays, so its EF
latents, noise maps and step arithmetic are f32 whatever the pipeline's
dtype, and its layers, which cast each weight to the activation's dtype, run
the UNet on those latents in f32. Here too: the latents are f32 (the alphas
enter as f32 scalars) and the port's layers cast their weights the same way,
so a bf16 pipeline's UNet computes in f32 and its self-attention runs in the
f32 flash kernels. The guidance scales are rounded to the
embeddings' dtype (the pipeline's), as the JAX editors make them.

The noise of ``sample_xts_from_x0`` comes from a ``torch.Generator`` (the
JAX package draws it from ``jax.random``, which torch cannot reproduce), one
draw of one image's shape shared by the N images, as the JAX batched class
gives every image the same key. ``xts_from_noise`` takes a given noise
instead, and ``ef_forward_process`` given noisings (``xts0``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from pnpinversion_tpu_torch.control.base import NO_CONTROL, BaseControl
from pnpinversion_tpu_torch.models.unet import UNet, apply_images
from pnpinversion_tpu_torch.sampling.p2p_forward import _callback
from pnpinversion_tpu_torch.schedulers.ddim import DDIMSchedule, _scalar, _sqrt, ddim_variance


def sample_xts_from_x0(generator: Optional[torch.Generator], schedule: DDIMSchedule,
                       x0: torch.Tensor) -> torch.Tensor:
    """Independent (not chained) noisings of x0 (N, 1, h, w, c): entry k ~
    q(x_t | x0) at t = timesteps[T-k], entry 0 = x0. One image's noise,
    drawn in x0's dtype from ``generator``, is shared by the images.
    Returns (N, T+1, 1, h, w, c) f32."""
    noise = torch.randn((schedule.num_steps,) + tuple(x0.shape[1:]), generator=generator,
                        device=x0.device, dtype=torch.float32)
    return xts_from_noise(schedule, x0, noise.to(x0.dtype))


def xts_from_noise(schedule: DDIMSchedule, x0: torch.Tensor,
                   noise: torch.Tensor) -> torch.Tensor:
    """``sample_xts_from_x0`` on a given noise (T, 1, h, w, c)."""
    T = schedule.num_steps
    ts = list(schedule.timesteps[::-1])
    a = torch.from_numpy(schedule.alphas_cumprod[ts]).to(x0.device).view(
        (1, T) + (1,) * (x0.dim() - 1))
    x0 = x0.float()
    xts = x0[:, None] * a ** 0.5 + noise.float()[None] * (1.0 - a) ** 0.5
    return torch.cat([x0[:, None], xts], dim=1)


def _step_terms(schedule: DDIMSchedule, t: int, eta: float):
    """f32 scalars of the eta-DDIM step at t: (sqrt(1 - alpha_t),
    sqrt(alpha_t), sqrt(alpha_prev), sqrt(1 - alpha_prev - eta var),
    eta sqrt(var))."""
    alpha_t = schedule.alpha_at(t)
    alpha_prev = schedule.alpha_at(t - schedule.step_ratio)
    var = ddim_variance(schedule, t)
    one, eta32 = np.float32(1.0), np.float32(eta)
    return tuple(float(x) for x in (_sqrt(one - alpha_t), _sqrt(alpha_t), _sqrt(alpha_prev),
                                    _sqrt(one - alpha_prev - eta32 * var), eta32 * _sqrt(var)))


def _mean(schedule: DDIMSchedule, t: int, eta: float, x: torch.Tensor,
          eps: torch.Tensor) -> Tuple[torch.Tensor, float]:
    """The step's mean mu from x_t and eps (both f32), and eta * sigma_t."""
    s1a, sa, sap, sdir, sigma = _step_terms(schedule, t, eta)
    x0_pred = (x - s1a * eps) / sa
    return sap * x0_pred + sdir * eps, sigma


def ef_forward_process(
    unet: UNet,
    schedule: DDIMSchedule,
    x0: torch.Tensor,  # (N, 1, h, w, c)
    cond_embedding: torch.Tensor,  # (N, 1, 77, D) source prompt
    uncond_embedding: torch.Tensor,  # (N, 1, 77, D)
    cfg_scale: float,
    generator: Optional[torch.Generator] = None,
    eta: float = 1.0,
    xts0: Optional[torch.Tensor] = None,  # (N, T+1, 1, h, w, c) noisings of x0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extract the per-step noise maps with ``unet`` computing in f32.
    Returns (zs (N, T, 1, h, w, c), the re-chained trajectory xts (N, T+1,
    1, h, w, c)), both f32; zs[:, 0] is zero."""
    T = schedule.num_steps
    if xts0 is None:
        xts0 = sample_xts_from_x0(generator, schedule, x0)
    xts0 = xts0.float()
    ctx = torch.cat([uncond_embedding, cond_embedding], dim=1)
    g = _scalar(cfg_scale, cond_embedding)
    xt = xts0[:, T]
    zs, xs = [], []
    for i in range(T):
        t = schedule.timesteps[i]
        eps2, _ = apply_images(unet, torch.cat([xt, xt], dim=1), t, ctx)
        eps = eps2[:, :1] + g * (eps2[:, 1:] - eps2[:, :1])
        mu, sigma = _mean(schedule, t, eta, xt, eps)
        z = (xts0[:, T - 1 - i] - mu) / sigma
        xt = mu + sigma * z  # the trajectory re-chained through the extracted z
        zs.append(z)
        xs.append(xt)
    zs[-1] = torch.zeros_like(zs[-1])
    # entries 0..T-1 are the re-chained latents, entry T the sampled endpoint
    return (torch.stack(zs[::-1], dim=1),
            torch.cat([torch.stack(xs[::-1], dim=1), xts0[:, T:]], dim=1))


def ef_reverse_process(
    unet: UNet,
    schedule: DDIMSchedule,
    xT: torch.Tensor,  # (N, 1, h, w, c) start latent (xts[:, T - skip])
    zs: torch.Tensor,  # (N, Z, 1, h, w, c)
    cond_embeddings: torch.Tensor,  # (N, B, 77, D)
    uncond_embeddings: torch.Tensor,  # (N, B, 77, D)
    cfg_scales: Sequence[float],  # (B,) per-row guidance
    eta: float = 1.0,
    control: BaseControl = NO_CONTROL,
    tensors: Optional[Dict[str, torch.Tensor]] = None,
    num_zs: Optional[int] = None,
) -> torch.Tensor:
    """DDPM-like sampling that re-injects the stored noise maps: step k runs
    at t = timesteps[T - Z + k] and adds zs[:, Z - 1 - k]. Each row has its
    own guidance scale; ``unet`` computes in f32. Returns the final latents
    (N, B, h, w, c), f32."""
    T = schedule.num_steps
    Z = num_zs if num_zs is not None else zs.shape[1]
    N, B = cond_embeddings.shape[:2]
    ctx = torch.cat([uncond_embeddings, cond_embeddings], dim=1)
    latents = xT.float().expand((N, B) + xT.shape[2:])
    state = control.init_state(B, heads=unet.config.num_heads, device=xT.device, images=N)
    scales = torch.tensor([_scalar(g, cond_embeddings) for g in cfg_scales],
                          dtype=torch.float32, device=xT.device).view(1, B, 1, 1, 1)
    for k in range(Z):
        t = schedule.timesteps[T - Z + k]
        eps2, state = apply_images(unet, torch.cat([latents, latents], dim=1), t, ctx, control,
                                   tensors, state, k)
        eps = eps2[:, :B] + scales * (eps2[:, B:] - eps2[:, :B])
        mu, sigma = _mean(schedule, t, eta, latents, eps)
        latents = mu + sigma * zs[:, Z - 1 - k]
        latents, state = _callback(control, latents, tensors, state, k)
    return latents
