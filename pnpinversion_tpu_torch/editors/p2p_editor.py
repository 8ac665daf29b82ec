"""P2P-family editor (port of ``pnpinversion_tpu/editors/p2p_editor.py``).

This slice ports the flagship method, ``directinversion+p2p``, in its fused
form: DDIM inversion of the source image, one (2B-1)-row scan that computes
the DirectInversion offsets and the controlled edit together, and one batched
VAE decode of the reconstruction (traj[0], exact by construction) and the
edit. The result is the 4-panel strip [instruction | ground truth |
reconstruction | edit], uint8 (H, 4W, 3).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from pnpinversion_tpu_torch.control.p2p import P2PControl, P2PSpec, make_p2p_control
from pnpinversion_tpu_torch.inversion.ddim_inversion import ddim_invert_loop
from pnpinversion_tpu_torch.models.vae import image_to_latent, latent_to_image
from pnpinversion_tpu_torch.pipeline import SDPipeline
from pnpinversion_tpu_torch.sampling.p2p_forward import fused_direct_inversion_edit_srcfree
from pnpinversion_tpu_torch.utils.image import load_image, make_strip, txt_draw

METHOD = "directinversion+p2p"


class P2PEditor:
    def __init__(self, pipeline: SDPipeline):
        self.pipe = pipeline

    def __call__(self, edit_method: str, image_path, prompt_src: str, prompt_tar: str,
                 guidance_scale: float = 7.5, cross_replace_steps: float = 0.4,
                 self_replace_steps: float = 0.6, blend_word=None, eq_params=None,
                 is_replace_controller: bool = False) -> np.ndarray:
        if edit_method != METHOD:
            raise NotImplementedError(
                f"{edit_method!r} is not ported yet: this package runs {METHOD!r} only; "
                "the other P2P-family methods are ROADMAP item A7")
        return self.edit_direct_inversion(
            image_path, prompt_src, prompt_tar, guidance_scale=guidance_scale,
            cross_replace_steps=cross_replace_steps, self_replace_steps=self_replace_steps,
            blend_word=blend_word, eq_params=eq_params,
            is_replace_controller=is_replace_controller)

    # ------------------------------------------------------------- phases
    def encode_image(self, image: np.ndarray) -> torch.Tensor:
        """uint8 (H, W, 3) -> scaled latent (1, h, w, 4)."""
        img = torch.as_tensor(np.ascontiguousarray(image), device=self.pipe.device)
        return image_to_latent(self.pipe.vae, img, dtype=self.pipe.dtype)

    def decode_image(self, latents: torch.Tensor) -> np.ndarray:
        """(B, h, w, 4) -> uint8 (B, H, W, 3) on the host."""
        return latent_to_image(self.pipe.vae, latents).cpu().numpy()

    def embeds(self, prompts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        cond = self.pipe.encode_prompt(prompts)
        uncond = self.pipe.encode_prompt([""] * len(prompts))
        return cond, uncond

    def invert(self, latent: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
        return ddim_invert_loop(self.pipe.unet, self.pipe.schedule, latent, embedding)

    def make_control(self, prompts, cross_replace_steps=0.4, self_replace_steps=0.6,
                     blend_word=None, eq_params=None, is_replace_controller=False):
        pipe = self.pipe
        ctrl, tensors = make_p2p_control(
            prompts, pipe.tokenizer, num_steps=pipe.schedule.num_steps,
            cross_replace_steps=cross_replace_steps, self_replace_steps=self_replace_steps,
            is_replace_controller=is_replace_controller, blend_words=blend_word,
            eq_params=eq_params, num_lb_slots=pipe.num_lb_slots, lb_res=pipe.lb_res,
            latent_size=pipe.latent_size, device=pipe.device)
        return ctrl.spec, tensors

    def fused_edit(self, spec: P2PSpec, traj, cond, uncond, guidance_scale, tensors):
        """The source-free fused offsets+edit scan; final latents (B, h, w, 4)."""
        control = P2PControl(dataclasses.replace(spec, uncond_rows=spec.batch_size - 1))
        return fused_direct_inversion_edit_srcfree(
            self.pipe.unet, self.pipe.schedule, traj, cond, uncond, guidance_scale, control,
            tensors)

    def strip(self, prompt_src, prompt_tar, image_gt, recon, edit) -> np.ndarray:
        size = self.pipe.config.image_size
        instruct = txt_draw(f"source prompt: {prompt_src}\ntarget prompt: {prompt_tar}",
                            target_size=(size, size))
        return make_strip([instruct, image_gt, recon, edit])

    # ------------------------------------------------------------- method
    @torch.inference_mode()
    def edit_direct_inversion(self, image_path, prompt_src, prompt_tar, guidance_scale=7.5,
                              cross_replace_steps=0.4, self_replace_steps=0.6,
                              blend_word=None, eq_params=None,
                              is_replace_controller=False) -> np.ndarray:
        """directinversion+p2p with full offsets, fused (the JAX editor's
        default branch)."""
        image_gt = load_image(image_path, self.pipe.config.image_size)
        prompts = [prompt_src, prompt_tar]
        latent = self.encode_image(image_gt)
        cond, uncond = self.embeds(prompts)
        traj = self.invert(latent, cond[:1])
        spec, tensors = self.make_control(prompts, cross_replace_steps, self_replace_steps,
                                          blend_word, eq_params, is_replace_controller)
        edit_latents = self.fused_edit(spec, traj, cond, uncond, guidance_scale, tensors)
        both = self.decode_image(torch.cat([traj[0], edit_latents[-1:]], dim=0))
        return self.strip(prompt_src, prompt_tar, image_gt, both[0], both[1])
