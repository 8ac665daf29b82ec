"""Plug-and-Play editor (port of ``pnpinversion_tpu/editors/pnp_editor.py``).

Methods:

- ``ddim+pnp``: invert, re-denoise from the inverted latent to get the
  reconstruction trajectory, then sample with feature and attention
  injection, the source row fed the re-denoised latents;
- ``directinversion+pnp``: the source row is fed the inversion's own
  latents at each step.

Like the JAX package, the editor's schedule has ``steps_offset=1`` (the
scheduler config of SD1.5, which the PnP reference runs), so its timesteps
are 981, ..., 1 at 50 steps. The injection loop runs 3 UNet rows per image,
[source, x, x], under the embeddings ["", negative prompt, target]: one
negative-prompt CFG on x, not the 2B-row CFG layout of the P2P loops.
"""
from __future__ import annotations

import numpy as np
import torch

from pnpinversion_tpu_torch.control.pnp import PnPControl, make_pnp_control
from pnpinversion_tpu_torch.editors.base import Editor
from pnpinversion_tpu_torch.inversion.ddim_inversion import ddim_invert_loop
from pnpinversion_tpu_torch.models.unet import UNet, apply_images
from pnpinversion_tpu_torch.pipeline import SDPipeline
from pnpinversion_tpu_torch.schedulers.ddim import (
    DDIMSchedule,
    classifier_free_guidance,
    ddim_step,
    make_ddim_schedule,
)

NEGATIVE_PROMPT = "ugly, blurry, black, low res, unrealistic"
METHODS = ("ddim+pnp", "directinversion+pnp")


def ddim_sample_trajectory(unet: UNet, schedule: DDIMSchedule, x: torch.Tensor,
                           embedding: torch.Tensor) -> torch.Tensor:
    """Plain single-embedding DDIM sampling of N images: x (N, 1, h, w, c),
    embedding (N, 1, 77, D); returns every step's output (N, T, 1, h, w, c)."""
    out = []
    for i in range(schedule.num_steps):
        t = schedule.timesteps[i]
        eps, _ = apply_images(unet, x, t, embedding)
        x = ddim_step(schedule, eps, t, x)
        out.append(x)
    return torch.stack(out, dim=1)


def pnp_sample_loop(unet: UNet, schedule: DDIMSchedule, control: PnPControl,
                    source_latents: torch.Tensor, x0: torch.Tensor, embeds: torch.Tensor,
                    guidance_scale: float) -> torch.Tensor:
    """The injection sampling of N images at 3 UNet rows each.

    source_latents (N, T, 1, h, w, c): row 0's latent at each step; x0
    (N, 1, h, w, c): the start latent; embeds (N, 3, 77, D) = [source "",
    negative prompt, target]. Returns the final latents (N, 1, h, w, c).
    """
    x = x0
    for i in range(schedule.num_steps):
        t = schedule.timesteps[i]
        eps3, _ = apply_images(unet, torch.cat([source_latents[:, i], x, x], dim=1), t, embeds,
                               control, {}, {}, i)
        eps = classifier_free_guidance(eps3[:, 1:2], eps3[:, 2:3], guidance_scale)
        x = ddim_step(schedule, eps, t, x)
    return x


def pnp_embeds(pipe: SDPipeline, prompts_tar) -> torch.Tensor:
    """(N, 3, 77, D): ["", negative prompt, target] for each target prompt."""
    fixed = pipe.encode_prompt(["", NEGATIVE_PROMPT])
    tar = pipe.encode_prompt(list(prompts_tar))
    return torch.cat([fixed[None].expand(tar.shape[0], -1, -1, -1), tar[:, None]], dim=1)


class PnPEditor(Editor):
    def __init__(self, pipeline: SDPipeline, steps_offset: int = 1):
        super().__init__(pipeline)
        self.schedule = make_ddim_schedule(num_steps=pipeline.schedule.num_steps,
                                           steps_offset=steps_offset)

    def __call__(self, edit_method, image_path, prompt_src, prompt_tar,
                 guidance_scale=7.5) -> np.ndarray:
        if edit_method == "ddim+pnp":
            return self.edit_ddim(image_path, prompt_src, prompt_tar, guidance_scale)
        if edit_method == "directinversion+pnp":
            return self.edit_direct_inversion(image_path, prompt_src, prompt_tar,
                                              guidance_scale)
        raise NotImplementedError(f"No edit method named {edit_method}")

    def _start(self, image_path, prompt_src):
        """The ground-truth image, the source prompt's embedding (1, 1, 77, D)
        and the DDIM inversion under it (1, T+1, 1, h, w, 4)."""
        pipe = self.pipe
        image_gt = self.load(image_path)
        cond_src = pipe.encode_prompt([prompt_src])[None]
        traj = ddim_invert_loop(pipe.unet, self.schedule, self.encode_image(image_gt)[None],
                                cond_src)
        return image_gt, cond_src, traj

    def _edit(self, source_latents, x0, prompt_tar, guidance_scale) -> torch.Tensor:
        control = make_pnp_control(self.pipe.config.unet, self.schedule.num_steps)
        return pnp_sample_loop(self.pipe.unet, self.schedule, control, source_latents, x0,
                               pnp_embeds(self.pipe, [prompt_tar]), guidance_scale)

    def _finish(self, prompt_src, prompt_tar, image_gt, recon, edit) -> np.ndarray:
        both = self.decode_image(torch.cat([recon[0], edit[0]]))
        return self.strip(prompt_src, prompt_tar, image_gt, both[0], both[1])

    @torch.inference_mode()
    def edit_ddim(self, image_path, prompt_src, prompt_tar, guidance_scale=7.5) -> np.ndarray:
        image_gt, cond_src, traj = self._start(image_path, prompt_src)
        recon_traj = ddim_sample_trajectory(self.pipe.unet, self.schedule, traj[:, -1], cond_src)
        edited = self._edit(recon_traj, recon_traj[:, 0], prompt_tar, guidance_scale)
        return self._finish(prompt_src, prompt_tar, image_gt, recon_traj[:, -1], edited)

    @torch.inference_mode()
    def edit_direct_inversion(self, image_path, prompt_src, prompt_tar,
                              guidance_scale=7.5) -> np.ndarray:
        image_gt, _, traj = self._start(image_path, prompt_src)
        # the source row gets the inversion latent of its level: [x_T, ..., x_1]
        source_latents = traj.flip(1)[:, :-1]
        edited = self._edit(source_latents, traj[:, -1], prompt_tar, guidance_scale)
        return self._finish(prompt_src, prompt_tar, image_gt, traj[:, 1], edited)
