"""Blended Latent Diffusion editor (port of
``pnpinversion_tpu/editors/bld_editor.py``).

SD2.1-base (``configs.SD21``): start from pure noise, denoise with the
target prompt over the last (1 - blending_percentage) of the schedule, and
after every step blend the background back in from a freshly noised source
latent, using the PIE ground-truth mask resized to the latent size (PIL
nearest). The result is the strip [instruction | original | zeros | edit]:
the method has no reconstruction.

The noise comes from a ``torch.Generator`` seeded with ``seed`` (the JAX
package draws it from ``jax.random``), in the JAX package's order: the start
latents first, then one draw per step, each of one image's shape and shared
by a batch's images (the JAX batched class gives every image the same key).
Everything runs in the pipeline's dtype.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from PIL import Image

from pnpinversion_tpu_torch.editors.base import Editor
from pnpinversion_tpu_torch.editors.instruct_editor import draw_noise
from pnpinversion_tpu_torch.models.unet import UNet, apply_images
from pnpinversion_tpu_torch.schedulers.ddim import (
    DDIMSchedule,
    add_noise,
    classifier_free_guidance,
    ddim_step,
)
from pnpinversion_tpu_torch.utils.image import make_strip, txt_draw
from pnpinversion_tpu_torch.utils.observability import host_sync, spanned

METHOD = "blended-latent-diffusion"


def bld_unet_calls(num_steps: int, blending_percentage: float = 0.25) -> int:
    """UNet calls (2 rows per image each) of one edit."""
    return num_steps - int(num_steps * blending_percentage)


def latent_mask(mask, latent_size: int) -> np.ndarray:
    """A PIE mask (H, W) or (H, W, C) of {0, 1} -> the latent mask
    (latent_size, latent_size, 1) f32: the uint8 mask resized with PIL's
    nearest, then thresholded at 0.5."""
    mask = np.asarray(mask, dtype=np.float32)
    if mask.ndim == 3:
        mask = mask[:, :, 0]
    small = Image.fromarray(mask.astype(np.uint8)).resize((latent_size, latent_size),
                                                          Image.NEAREST)
    return (np.array(small) >= 0.5).astype(np.float32)[..., None]


@spanned("pnpi.edit.sample")
def bld_sample(unet: UNet, schedule: DDIMSchedule, source_latents: torch.Tensor,
               mask: torch.Tensor, ctx: torch.Tensor, guidance_scale: float,
               generator: Optional[torch.Generator],
               blending_percentage: float = 0.25) -> torch.Tensor:
    """Blended sampling of N images: source_latents (N, 1, h, w, 4); mask
    (N, h, w, 1) in {0, 1} (1 where the edit goes); ctx (N, 2, 77, D) =
    [uncond, target]. Returns the latents (N, 1, h, w, 4) in the source's
    dtype."""
    T = schedule.num_steps
    start = int(T * blending_percentage)
    one = tuple(source_latents.shape[1:])
    dtype = source_latents.dtype
    mask = mask[:, None].to(dtype)
    keep = 1.0 - mask
    lat = draw_noise(generator, one, dtype).expand(source_latents.shape)
    for i in range(T - start):
        t = schedule.timesteps[start + i]
        eps2, _ = apply_images(unet, torch.cat([lat, lat], dim=1), t, ctx)
        eps = classifier_free_guidance(eps2[:, :1], eps2[:, 1:], guidance_scale)
        lat = ddim_step(schedule, eps, t, lat)
        noised_src = add_noise(schedule, source_latents, draw_noise(generator, one, dtype), t)
        lat = lat * mask + noised_src * keep
    return lat


class BlendedLatentDiffusionEditor(Editor):
    """``blended-latent-diffusion`` on an SD2.1 pipeline
    (``SDPipeline.create(SD21, ...)``)."""

    def __call__(self, edit_method, image_path, mask, prompt_tar, guidance_scale=7.5,
                 blending_percentage=0.25, seed: int = 42) -> np.ndarray:
        if edit_method != METHOD:
            raise NotImplementedError(f"No edit method named {edit_method}")
        return self.edit(image_path, mask, prompt_tar, guidance_scale, blending_percentage,
                         seed)

    def load(self, image_path) -> np.ndarray:
        """A path (resized bilinear, as the reference's BLD runner does) or an
        array, uint8 (H, W, 3)."""
        if isinstance(image_path, str):
            size = self.pipe.config.image_size
            img = Image.open(image_path).resize((size, size), Image.BILINEAR)
            return np.array(img)[:, :, :3]
        return np.asarray(image_path)[:, :, :3]

    @torch.inference_mode()
    def edit(self, image_path, mask, prompt_tar, guidance_scale=7.5, blending_percentage=0.25,
             seed: int = 42) -> np.ndarray:
        pipe = self.pipe
        size = pipe.config.image_size
        image_ori = self.load(image_path)
        host_sync("mask", pipe.device)
        m = torch.as_tensor(latent_mask(mask, pipe.latent_size), device=pipe.device)
        ctx = pipe.encode_prompt(["", prompt_tar])[None]
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        lat = bld_sample(pipe.unet, pipe.schedule, self.encode_image(image_ori)[None], m[None],
                         ctx, guidance_scale, gen, blending_percentage)
        edit = self.decode_image(lat[:, 0])[0]
        instruct = txt_draw(f"edit prompt: {prompt_tar}", target_size=(size, size))
        return make_strip([instruct, image_ori, np.zeros_like(instruct), edit])
