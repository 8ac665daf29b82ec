"""P2P-family editor (port of ``pnpinversion_tpu/editors/p2p_editor.py``).

Methods ported so far (every other method string raises NotImplementedError):
- ``directinversion+p2p``, in its fused form: DDIM inversion of the source
  image, one (2B-1)-row scan that computes the DirectInversion offsets and the
  controlled edit together, and one batched VAE decode of the reconstruction
  (traj[0], exact by construction) and the edit;
- ``null-text-inversion+p2p`` (and its ``_a800``/``_3090`` aliases): DDIM
  inversion, null-text optimisation (per-step Adam on the uncond embedding,
  differentiated through the UNet), then the CFG reconstruction at 2 rows and
  the P2P-controlled edit at 2B rows with the optimised per-step embeddings;
- ``ddim+p2p``: the same two loops with the plain "" embedding.

The result is the 4-panel strip [instruction | ground truth | reconstruction |
edit], uint8 (H, 4W, 3).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from pnpinversion_tpu_torch.control.base import NO_CONTROL
from pnpinversion_tpu_torch.control.p2p import P2PControl, P2PSpec, make_p2p_control
from pnpinversion_tpu_torch.inversion.ddim_inversion import (
    ddim_invert_loop,
    null_text_optimization,
)
from pnpinversion_tpu_torch.models.vae import image_to_latent, latent_to_image
from pnpinversion_tpu_torch.pipeline import SDPipeline
from pnpinversion_tpu_torch.sampling.p2p_forward import (
    fused_direct_inversion_edit_srcfree,
    guidance_forward,
)
from pnpinversion_tpu_torch.utils.image import load_image, make_strip, txt_draw

NULL_TEXT_METHODS = ("null-text-inversion+p2p", "null-text-inversion+p2p_a800",
                     "null-text-inversion+p2p_3090")
METHODS = ("directinversion+p2p", "ddim+p2p") + NULL_TEXT_METHODS


class P2PEditor:
    def __init__(self, pipeline: SDPipeline):
        self.pipe = pipeline

    def __call__(self, edit_method: str, image_path, prompt_src: str, prompt_tar: str,
                 guidance_scale: float = 7.5, cross_replace_steps: float = 0.4,
                 self_replace_steps: float = 0.6, blend_word=None, eq_params=None,
                 is_replace_controller: bool = False) -> np.ndarray:
        kw = dict(guidance_scale=guidance_scale, cross_replace_steps=cross_replace_steps,
                  self_replace_steps=self_replace_steps, blend_word=blend_word,
                  eq_params=eq_params, is_replace_controller=is_replace_controller)
        if edit_method == "directinversion+p2p":
            return self.edit_direct_inversion(image_path, prompt_src, prompt_tar, **kw)
        if edit_method == "ddim+p2p":
            return self.edit_ddim(image_path, prompt_src, prompt_tar, **kw)
        if edit_method in NULL_TEXT_METHODS:
            return self.edit_null_text(image_path, prompt_src, prompt_tar, **kw)
        raise NotImplementedError(
            f"{edit_method!r} is not ported yet: this package runs {', '.join(METHODS)}; "
            "the other P2P-family methods are ROADMAP item A7")

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

    def null_text(self, traj, uncond, cond, guidance_scale, num_inner_steps=10):
        """Per-step optimised uncond embeddings (T, 1, 77, D); uncond/cond (1, 77, D)."""
        return null_text_optimization(self.pipe.unet, self.pipe.schedule, traj, uncond, cond,
                                      guidance_scale, num_inner_steps=num_inner_steps)

    def guided(self, latent, cond, uncond, guidance_scale, spec=None, tensors=None):
        """The CFG loop at 2B rows, P2P-controlled when ``spec`` is given;
        final latents (B, h, w, 4)."""
        control = NO_CONTROL if spec is None else P2PControl(spec)
        return guidance_forward(self.pipe.unet, self.pipe.schedule, latent, cond, uncond,
                                guidance_scale, control, tensors)

    def strip(self, prompt_src, prompt_tar, image_gt, recon, edit) -> np.ndarray:
        size = self.pipe.config.image_size
        instruct = txt_draw(f"source prompt: {prompt_src}\ntarget prompt: {prompt_tar}",
                            target_size=(size, size))
        return make_strip([instruct, image_gt, recon, edit])

    # ------------------------------------------------------------- methods
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

    def _recon_and_edit(self, prompts, image_gt, traj, cond, uncond_recon, uncond_edit,
                        guidance_scale, control_kw) -> np.ndarray:
        """The CFG reconstruction of the source row and the P2P edit, both from
        traj[-1], decoded in one batched VAE call."""
        x_t = traj[-1]
        recon = self.guided(x_t, cond[:1], uncond_recon, guidance_scale)
        spec, tensors = self.make_control(prompts, **control_kw)
        edit = self.guided(x_t, cond, uncond_edit, guidance_scale, spec, tensors)
        both = self.decode_image(torch.cat([recon, edit[-1:]], dim=0))
        return self.strip(prompts[0], prompts[1], image_gt, both[0], both[1])

    @torch.inference_mode()
    def edit_ddim(self, image_path, prompt_src, prompt_tar, guidance_scale=7.5,
                  **control_kw) -> np.ndarray:
        """ddim+p2p: plain DDIM inversion and the "" uncond embedding."""
        image_gt = load_image(image_path, self.pipe.config.image_size)
        prompts = [prompt_src, prompt_tar]
        cond, uncond = self.embeds(prompts)
        traj = self.invert(self.encode_image(image_gt), cond[:1])
        return self._recon_and_edit(prompts, image_gt, traj, cond, uncond[:1], uncond,
                                    guidance_scale, control_kw)

    @torch.no_grad()
    def edit_null_text(self, image_path, prompt_src, prompt_tar, guidance_scale=7.5,
                       num_inner_steps=10, **control_kw) -> np.ndarray:
        """null-text-inversion+p2p. Not in inference mode: the null-text phase
        differentiates through the UNet (its inner loop turns grad on), so the
        embeddings, made in inference mode, are cloned into normal tensors."""
        image_gt = load_image(image_path, self.pipe.config.image_size)
        prompts = [prompt_src, prompt_tar]
        cond, uncond = (x.clone() for x in self.embeds(prompts))
        traj = self.invert(self.encode_image(image_gt), cond[:1])
        uncond_steps = self.null_text(traj, uncond[:1], cond[:1], guidance_scale,
                                      num_inner_steps)
        return self._recon_and_edit(prompts, image_gt, traj, cond, uncond_steps, uncond_steps,
                                    guidance_scale, control_kw)
