"""pix2pix-zero editor (port of ``pnpinversion_tpu/editors/pix2pix_zero_editor.py``).

Caption the input image (BLIP, ``models/blip.py``; or ``caption=``): the
caption is both the inversion prompt and the negative prompt. Encode the
image to a VAE posterior sample, invert with noise regularisation, take the
edit direction as the difference of the target and source prompts' mean
embeddings, then run the two-pass cross-attention guided edit
(``XA_GUIDANCE`` 0.1). ``directinversion+pix2pix-zero`` adds the inversion
trajectory's offsets to both passes. The schedule has ``steps_offset=1``.

The posterior noise comes from a ``torch.Generator`` seeded with ``seed`` on
the pipeline's device, the autocorrelation rolls from a CPU one seeded the
same (the JAX package draws both from ``jax.random``). The method
differentiates through the UNet, so it runs outside inference mode, with the
embeddings cloned out of it. The result is the strip [instruction | ground
truth | reconstruction | edit].
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from pnpinversion_tpu_torch.editors.base import Editor
from pnpinversion_tpu_torch.editors.instruct_editor import draw_noise
from pnpinversion_tpu_torch.inversion.pix2pix_zero import draw_shifts, p2z_edit, p2z_invert
from pnpinversion_tpu_torch.pipeline import SDPipeline
from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule

XA_GUIDANCE = 0.1
METHODS = ("ddim+pix2pix-zero", "directinversion+pix2pix-zero")


def construct_direction(pipe: SDPipeline, src_sentences: Sequence[str],
                        tgt_sentences: Sequence[str]) -> torch.Tensor:
    """The mean target sentence embedding minus the mean source one,
    (1, 77, D) in the pipeline's dtype."""
    emb_src = pipe.encode_prompt(list(src_sentences)).mean(dim=0, keepdim=True)
    emb_tar = pipe.encode_prompt(list(tgt_sentences)).mean(dim=0, keepdim=True)
    return (emb_tar - emb_src).clone()


def posterior_latents(pipe: SDPipeline, images_u8, generator: Optional[torch.Generator]
                      ) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> scaled VAE posterior samples (N, 1, h, w, 4),
    encoded in the pipeline's dtype, on one noise draw of one image's shape
    shared by the images."""
    images = torch.as_tensor(np.ascontiguousarray(images_u8), device=pipe.device)
    n, lat = images.shape[0], pipe.latent_size
    noise = draw_noise(generator, (1, lat, lat, pipe.config.vae.latent_channels), pipe.dtype)
    x = images.to(pipe.dtype) / 127.5 - 1.0
    return pipe.vae.encode(x, noise=noise.expand(n, -1, -1, -1))[:, None]


def p2z_latents(pipe: SDPipeline, schedule, images_u8, cond_caption: torch.Tensor,
                edit_dir: torch.Tensor, guidance_scale: float, use_offsets: bool, seed: int,
                xa_guidance: float = XA_GUIDANCE):
    """The method on N images: images_u8 (N, H, W, 3); cond_caption and
    edit_dir (N, 1, 77, D). Returns (recon, edit) latents (N, 1, h, w, 4)."""
    noise_gen = torch.Generator(device=pipe.device).manual_seed(seed)
    shifts = draw_shifts(torch.Generator().manual_seed(seed), pipe.latent_size,
                         schedule.num_steps)
    cond_caption, edit_dir = cond_caption.clone(), edit_dir.to(pipe.dtype).clone()
    traj = p2z_invert(pipe.unet, schedule, posterior_latents(pipe, images_u8, noise_gen),
                      cond_caption, shifts)
    return p2z_edit(pipe.unet, schedule, traj[:, -1], torch.cat([cond_caption] * 2, dim=1),
                    edit_dir, guidance_scale, xa_guidance, traj if use_offsets else None)


class Pix2PixZeroEditor(Editor):
    def __init__(self, pipeline: SDPipeline, captioner: Optional[Callable] = None,
                 steps_offset: int = 1):
        super().__init__(pipeline)
        self.captioner = captioner
        self.schedule = make_ddim_schedule(num_steps=pipeline.schedule.num_steps,
                                           steps_offset=steps_offset)

    def _caption(self, image: np.ndarray) -> str:
        if self.captioner is None:
            raise ValueError("no captioner configured; pass caption= or provide a BLIP captioner")
        return self.captioner(image)

    def __call__(self, edit_method, image_path, prompt_src, prompt_tar, guidance_scale=7.5,
                 caption: Optional[str] = None) -> np.ndarray:
        if edit_method not in METHODS:
            raise NotImplementedError(f"No edit method named {edit_method}")
        return self.edit(image_path, prompt_src, prompt_tar, guidance_scale, caption,
                         use_offsets=edit_method == METHODS[1])

    def load(self, image_path) -> np.ndarray:
        """A path (RGB, resized with Lanczos) or an array, uint8 (H, W, 3)."""
        if isinstance(image_path, str):
            size = self.pipe.config.image_size
            img = Image.open(image_path).convert("RGB")
            return np.asarray(img.resize((size, size), Image.Resampling.LANCZOS))
        return np.asarray(image_path)

    @torch.no_grad()
    def edit(self, image_path, prompt_src, prompt_tar, guidance_scale=7.5,
             caption: Optional[str] = None, use_offsets: bool = False,
             seed: int = 1234) -> np.ndarray:
        pipe = self.pipe
        image_gt = self.load(image_path)
        caption = caption if caption is not None else self._caption(image_gt)
        rec, edit = p2z_latents(pipe, self.schedule, image_gt[None],
                                pipe.encode_prompt([caption])[None],
                                construct_direction(pipe, [prompt_src], [prompt_tar])[None],
                                guidance_scale, use_offsets, seed)
        imgs = self.decode_image(torch.cat([rec[:, 0], edit[:, 0]]))
        return self.strip(prompt_src, prompt_tar, image_gt, imgs[0], imgs[1])
