"""StyleDiffusion editor (port of ``pnpinversion_tpu/editors/stylediffusion_editor.py``).

``stylediffusion+p2p``: DDIM inversion with the source prompt recording the
16^2 cross maps, per-step training of the mapping networks that turn the
CLIP ViT-B/16 image tokens into a learned V context, then two 2-prompt CFG
passes from the inverted latent: the reconstruction (every step's source and
target rows mapped, no P2P) and the edit (P2P with the taus v .5, c .6,
s .6, u .0 of the reference's benchmark run). Replace or Refine follows the
reference's character-length rule (``stylediffusion_is_replace``). The
result is the strip [instruction | ground truth | reconstruction pass row 0 |
edit pass row 1].

The networks' start is drawn from a ``torch.Generator`` seeded 0 on the
pipeline's device (the JAX package draws it from ``PRNGKey(0)``), or given
(``mapper0``). The training differentiates through the UNet, so the editor
runs outside inference mode, with the embeddings cloned out of it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pnpinversion_tpu_torch.control.p2p import make_p2p_control, stack_tensors
from pnpinversion_tpu_torch.control.stylediffusion import (
    StyleDiffusionControl,
    StyleDiffusionSpec,
)
from pnpinversion_tpu_torch.editors.base import Editor
from pnpinversion_tpu_torch.evaluation.metrics import center_crop_resize_224, clip_normalize
from pnpinversion_tpu_torch.inversion.stylediffusion import ddim_invert_with_maps, train_mappers
from pnpinversion_tpu_torch.models.stylediffusion import Params, init_mapper_params
from pnpinversion_tpu_torch.models.vit import ViT, ViTConfig, init_vit_
from pnpinversion_tpu_torch.pipeline import SDPipeline
from pnpinversion_tpu_torch.sampling.p2p_forward import guidance_forward

METHOD = "stylediffusion+p2p"
CLIP_VIT_B16 = ViTConfig(image_size=224, patch_size=16, width=768, layers=12, heads=12,
                         projection_dim=512)
TAUS = (0.5, 0.6, 0.6, 0.0)  # tau_v, tau_c, tau_s, tau_u


def stylediffusion_is_replace(prompt_src: str, prompt_tar: str) -> bool:
    """The reference's Replace-or-Refine rule for stylediffusion+p2p: Replace
    when the space-stripped prompts have as many CHARACTERS (not words). Where
    that holds but the word counts differ, the reference's replacement mapper
    raises; the JAX package then degrades to Refine, the one controller that
    can run, and so does the port."""
    if len(prompt_src.strip(" ")) != len(prompt_tar.strip(" ")):
        return False
    return len(prompt_src.split(" ")) == len(prompt_tar.split(" "))


def make_clip_vision(device, config: ViTConfig = CLIP_VIT_B16, seed: int = 42) -> ViT:
    """The CLIP vision tower with random weights drawn from ``seed``, f32."""
    with torch.device("meta"):
        model = ViT(config)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_vit_(model.to_empty(device=device), gen).eval().requires_grad_(False)


def image_tokens(clip: ViT, images_u8, device) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> the CLIP tower's post-layernorm tokens (N, 197,
    width), f32 (shortest side resized, centre crop, CLIP normalisation)."""
    size = clip.config.image_size
    x = torch.stack([clip_normalize(center_crop_resize_224(
        torch.as_tensor(np.asarray(im), device=device).float() / 255.0, size))
        for im in images_u8])
    tokens, _ = clip(x, return_tokens=True)
    return tokens


def initial_mapper(clip: ViT, images: int, device) -> Params:
    """The networks' start (the same for every image), one step's (N, ...)."""
    gen = torch.Generator(device=device).manual_seed(0)
    p = init_mapper_params(gen, 1, 1, tokens_in=clip.config.num_patches + 1)
    return {k: v[:, 0].expand((images,) + v.shape[2:]).clone() for k, v in p.items()}


def stylediffusion_latents(pipe: SDPipeline, clip: ViT, images_u8, cond_src: torch.Tensor,
                           cond2: torch.Tensor, guidance_scale: float, p2p, p2p_tensors,
                           num_inner_steps: int, taus=TAUS, mapper0: Optional[Params] = None):
    """The method on N images: images_u8 (N, H, W, 3); cond_src (N, 1, 77,
    D); cond2 (N, 2, 77, D) = [source, target]; the P2P control and its
    tensors stacked over the images. Returns (recon, edit) latents, each
    (N, 2, h, w, 4)."""
    unet, sched = pipe.unet, pipe.schedule
    T = sched.num_steps
    tau_v, _, _, tau_u = taus
    n = len(images_u8)
    images = torch.as_tensor(np.ascontiguousarray(images_u8), device=pipe.device)
    latent = pipe.vae.encode(images.to(pipe.dtype) / 127.5 - 1.0)[:, None]
    cond_src, cond2 = cond_src.clone(), cond2.clone()
    uncond1 = pipe.encode_prompt([""]).clone()[None].expand(n, -1, -1, -1)
    uncond2 = pipe.encode_prompt(["", ""]).clone()[None].expand(n, -1, -1, -1)
    tokens = image_tokens(clip, images_u8, pipe.device)
    traj, gt_maps = ddim_invert_with_maps(unet, sched, latent, cond_src)
    if mapper0 is None:
        mapper0 = initial_mapper(clip, n, pipe.device)
    mappers = train_mappers(unet, sched, traj, gt_maps, tokens, uncond1, cond_src,
                            guidance_scale, mapper0, num_inner_steps=num_inner_steps)
    sd = {"img_tokens": tokens, "sd_mapper": mappers}
    recon = guidance_forward(unet, sched, traj[:, -1], cond2, uncond2, guidance_scale,
                             StyleDiffusionControl(StyleDiffusionSpec(2, T, T)), sd)
    spec = StyleDiffusionSpec(2, T, int(tau_v * T), 0, int(tau_u * T))
    edit = guidance_forward(unet, sched, traj[:, -1], cond2, uncond2, guidance_scale,
                            StyleDiffusionControl(spec, p2p), {**p2p_tensors, **sd})
    return recon, edit


def stylediffusion_p2p(pipe: SDPipeline, prompts, blend_word=None, eq_params=None,
                       is_replace_controller=None, taus=TAUS):
    """(P2P control, one image's tensors) of the edit pass: cross replace
    tau_c, self replace tau_s."""
    is_replace = (bool(is_replace_controller) if is_replace_controller is not None
                  else stylediffusion_is_replace(*prompts))
    return make_p2p_control(
        list(prompts), pipe.tokenizer, num_steps=pipe.schedule.num_steps,
        cross_replace_steps={"default_": taus[1]}, self_replace_steps=taus[2],
        is_replace_controller=is_replace, blend_words=blend_word, eq_params=eq_params,
        num_lb_slots=pipe.num_lb_slots, lb_res=pipe.lb_res, latent_size=pipe.latent_size,
        device=pipe.device)


class StyleDiffusionEditor(Editor):
    def __init__(self, pipeline: SDPipeline, clip_vision: Optional[ViT] = None,
                 clip_vision_cfg: ViTConfig = CLIP_VIT_B16):
        super().__init__(pipeline)
        self.clip = (clip_vision if clip_vision is not None
                     else make_clip_vision(pipeline.device, clip_vision_cfg))

    def __call__(self, edit_method, image_path, prompt_src, prompt_tar, guidance_scale=7.5,
                 **kw) -> np.ndarray:
        if edit_method != METHOD:
            raise NotImplementedError(f"No edit method named {edit_method}")
        return self.edit(image_path, prompt_src, prompt_tar, guidance_scale, **kw)

    @torch.no_grad()
    def edit(self, image_path, prompt_src, prompt_tar, guidance_scale=7.5,
             cross_replace_steps=None, self_replace_steps=None, blend_word=None, eq_params=None,
             is_replace_controller=None, num_inner_steps=100, tau_v=0.5, tau_c=0.6, tau_s=0.6,
             tau_u=0.0, mapper0: Optional[Params] = None) -> np.ndarray:
        """``cross_replace_steps`` and ``self_replace_steps`` are ignored, as in
        the reference: the taus set them."""
        pipe = self.pipe
        image_gt = self.load(image_path)
        prompts = [prompt_src, prompt_tar]
        taus = (tau_v, tau_c, tau_s, tau_u)
        p2p, tensors = stylediffusion_p2p(pipe, prompts, blend_word, eq_params,
                                          is_replace_controller, taus)
        recon, edit = stylediffusion_latents(
            pipe, self.clip, image_gt[None], pipe.encode_prompt([prompt_src])[None],
            pipe.encode_prompt(prompts)[None], guidance_scale, p2p, stack_tensors([tensors]),
            num_inner_steps, taus, mapper0)
        imgs = self.decode_image(torch.cat([recon[:, 0], edit[:, -1]]))
        return self.strip(prompt_src, prompt_tar, image_gt, imgs[0], imgs[1])
