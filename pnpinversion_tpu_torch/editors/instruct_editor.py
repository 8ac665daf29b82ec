"""Instruction-conditioned editors: InstructPix2Pix and InstructDiffusion
(port of ``pnpinversion_tpu/editors/instruct_editor.py``).

- instruct-pix2pix: an 8-channel UNet (the latent and the unscaled VAE mean
  of the input image, concatenated on channels), Euler ancestral over
  k-diffusion's sigmas, the 3-way guidance
  ``uncond + sT (cond - img_cond) + sI (img_cond - uncond)``, sT 7.5, sI 1.5;
- instruct-diffusion: the same machinery with
  ``0.5 (img_cond + txt_cond) + sT (cond - img_cond) + sI (cond - txt_cond)``,
  sT 5.0, sI 1.25.

Both take the editing instruction instead of prompts and give the strip
[instruction | input | zeros | edit]. The image is encoded in the
pipeline's dtype; the sampling latents are f32 (the JAX package's f32 sigmas
make them so), so the UNet and the final decode compute in f32 (the layers
cast their weights to the activation's dtype, in both packages). The noise
comes from a ``torch.Generator`` seeded with ``seed`` (the JAX package draws
it from ``jax.random``, which torch cannot reproduce), one draw of one
image's shape per step, shared by a batch's images.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from PIL import Image

from pnpinversion_tpu_torch.editors.base import Editor
from pnpinversion_tpu_torch.models.unet import UNet, apply_images
from pnpinversion_tpu_torch.sampling.kdiffusion import (
    get_sigmas,
    sample_euler_ancestral,
    sigma_to_t,
)
from pnpinversion_tpu_torch.schedulers.ddim import DDIMSchedule, _scalar
from pnpinversion_tpu_torch.utils.image import make_strip, txt_draw

# method -> (variant, default text guidance, default image guidance)
VARIANTS = {"instruct-pix2pix": ("ip2p", 7.5, 1.5),
            "instruct-diffusion": ("instructdiff", 5.0, 1.25)}


def draw_noise(generator: Optional[torch.Generator], shape, dtype) -> torch.Tensor:
    """One standard normal draw of ``shape`` from ``generator``, rounded to
    ``dtype``."""
    device = generator.device if generator is not None else None
    return torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=torch.float32).to(dtype)


def instruct_sample(unet: UNet, schedule: DDIMSchedule, image_cond: torch.Tensor,
                    text_cond: torch.Tensor, text_uncond: torch.Tensor, steps: int,
                    cfg_text: float, cfg_image: float, generator: Optional[torch.Generator],
                    variant: str) -> torch.Tensor:
    """Euler-ancestral sampling of N images: image_cond (N, 1, h, w, 4), the
    unscaled VAE means; text_cond and text_uncond (N, 1, 77, D); ``unet``
    computes in f32 on the 8 channels; variant "ip2p" or "instructdiff".
    The rows of a UNet call are [cond, image-only, unconditional] (ip2p) or
    [cond, image-only, text-only] (instructdiff) per image. Returns the
    latents (N, 1, h, w, 4), f32."""
    sigmas = get_sigmas(schedule, steps)
    zeros = torch.zeros_like(image_cond)
    second = text_uncond if variant == "ip2p" else text_cond
    ctx3 = torch.cat([text_cond, text_uncond, second], dim=1)
    img3 = torch.cat([image_cond, image_cond, zeros], dim=1).float()
    ct, ci = (_scalar(g, text_cond) for g in (cfg_text, cfg_image))

    def denoise(x, sigma):
        c_in = float(np.float32(1.0) / np.sqrt(np.float32(1.0) + np.float32(sigma) ** 2))
        x_in = torch.cat([(x * c_in).expand(-1, 3, -1, -1, -1), img3], dim=-1)
        eps3, _ = apply_images(unet, x_in, sigma_to_t(schedule, sigma), ctx3)
        out_cond, out_img, out_third = eps3[:, :1], eps3[:, 1:2], eps3[:, 2:]
        if variant == "ip2p":
            eps = out_third + ct * (out_cond - out_img) + ci * (out_img - out_third)
        else:
            eps = (0.5 * (out_img + out_third) + ct * (out_cond - out_img)
                   + ci * (out_cond - out_third))
        return x - sigma * eps

    one = tuple(image_cond.shape[1:])  # one image's shape: a batch shares each draw
    z = draw_noise(generator, one, image_cond.dtype).float() * float(sigmas[0])
    x = z.expand(image_cond.shape).float()
    return sample_euler_ancestral(denoise, x, sigmas,
                                  lambda: draw_noise(generator, one, torch.float32))


class InstructEditor(Editor):
    """edit_method "instruct-pix2pix" or "instruct-diffusion"; the pipeline
    carries the 8-channel UNet (``configs.IP2P``)."""

    def __call__(self, edit_method, image_path, editing_instruction, steps=50, cfg_text=None,
                 cfg_image=None, seed=1234) -> np.ndarray:
        if edit_method not in VARIANTS:
            raise NotImplementedError(f"No edit method named {edit_method}")
        variant, ct, ci = VARIANTS[edit_method]
        return self.edit(image_path, editing_instruction, variant, steps, cfg_text or ct,
                         cfg_image or ci, seed)

    @torch.inference_mode()
    def edit(self, image_path, instruction, variant, steps=50, cfg_text=7.5, cfg_image=1.5,
             seed=1234) -> np.ndarray:
        pipe = self.pipe
        size = pipe.config.image_size
        if isinstance(image_path, str):
            img = Image.open(image_path).convert("RGB")
            image_np = np.array(img.resize((size, size), Image.Resampling.LANCZOS))
        else:
            image_np = np.asarray(image_path)
        image = torch.as_tensor(np.ascontiguousarray(image_np), device=pipe.device)
        image_cond = pipe.vae.encode((image.to(pipe.dtype) / 127.5 - 1.0)[None], scale=False)
        text_cond = pipe.encode_prompt([instruction])[None]
        text_uncond = pipe.encode_prompt([""])[None]
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        z = instruct_sample(pipe.unet, pipe.schedule, image_cond[:, None],
                            text_cond, text_uncond, steps, cfg_text, cfg_image, gen, variant)
        edit = self.decode_image(z[:, 0])[0]
        panel = txt_draw(f"edit prompt: {instruction}", target_size=(size, size))
        return make_strip([panel, image_np, np.zeros_like(panel), edit])
