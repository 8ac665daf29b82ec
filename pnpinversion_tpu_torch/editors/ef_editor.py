"""Edit-friendly DDPM editor (port of ``pnpinversion_tpu/editors/ef_editor.py``).

``edit-friendly-inversion+p2p``: extract the noise maps with the source
prompt (eta 1, source guidance 1), then one P2P-controlled 2-prompt reverse
pass from the re-chained latent at T - skip with the stored maps; Replace
when the prompts have as many words, else Refine, and self-attention
replaced only at maps of at most 16^2 pixels (the reference's copy of the
controller). The schedule has ``steps_offset=1`` (SD1.4's scheduler config).
The noise comes from a ``torch.Generator`` seeded with ``seed`` on the
pipeline's device. ``skip`` is at most T - 1, as in the batched class. The
image is encoded in the pipeline's dtype; both UNet passes and the final
decode compute in f32, as the f32 latents make the layers compute (in both
packages the layers cast their weights to the activation's dtype).

The result is the strip [instruction | ground truth | source row | target
row], uint8 (H, 4W, 3).
"""
from __future__ import annotations

import numpy as np
import torch

from pnpinversion_tpu_torch.control.p2p import make_p2p_control, stack_tensors
from pnpinversion_tpu_torch.editors.base import Editor
from pnpinversion_tpu_torch.inversion.ef_ddpm import ef_forward_process, ef_reverse_process
from pnpinversion_tpu_torch.pipeline import SDPipeline
from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule

METHOD = "edit-friendly-inversion+p2p"
EF_SELF_EDIT_MAX_SEQ = 16 * 16


def ef_control(pipe: SDPipeline, prompts, num_steps: int, cross_replace_steps=0.4,
               self_replace_steps=0.6):
    """(control, tensors) of one image's EF edit: Replace when the prompts
    have as many words, else Refine."""
    is_replace = len(prompts[0].split(" ")) == len(prompts[1].split(" "))
    return make_p2p_control(
        prompts, pipe.tokenizer, num_steps=num_steps, cross_replace_steps=cross_replace_steps,
        self_replace_steps=self_replace_steps, is_replace_controller=is_replace,
        num_lb_slots=pipe.num_lb_slots, lb_res=pipe.lb_res, latent_size=pipe.latent_size,
        self_edit_max_seq=EF_SELF_EDIT_MAX_SEQ, device=pipe.device)


class EditFriendlyEditor(Editor):
    def __init__(self, pipeline: SDPipeline, steps_offset: int = 1):
        super().__init__(pipeline)
        self.schedule = make_ddim_schedule(num_steps=pipeline.schedule.num_steps,
                                           steps_offset=steps_offset)

    def __call__(self, edit_method, image_path, prompt_src, prompt_tar,
                 source_guidance_scale=1.0, target_guidance_scale=7.5,
                 cross_replace_steps=0.4, self_replace_steps=0.6, eta=1.0, skip=12,
                 seed=1234) -> np.ndarray:
        if edit_method != METHOD:
            raise NotImplementedError(f"No edit method named {edit_method}")
        return self.edit(image_path, prompt_src, prompt_tar, source_guidance_scale,
                         target_guidance_scale, cross_replace_steps, self_replace_steps, eta,
                         skip, seed)

    @torch.inference_mode()
    def edit(self, image_path, prompt_src, prompt_tar, source_guidance_scale=1.0,
             target_guidance_scale=7.5, cross_replace_steps=0.4, self_replace_steps=0.6,
             eta=1.0, skip=12, seed=1234) -> np.ndarray:
        pipe, sched = self.pipe, self.schedule
        T = sched.num_steps
        skip = min(skip, T - 1)
        image_gt = self.load(image_path)
        prompts = [prompt_src, prompt_tar]
        cond = pipe.encode_prompt(prompts)[None]
        uncond = pipe.encode_prompt(["", ""])[None]
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        zs, xts = ef_forward_process(pipe.unet, sched, self.encode_image(image_gt)[None],
                                     cond[:, :1], uncond[:, :1], source_guidance_scale, gen,
                                     eta=eta)
        control, tensors = ef_control(pipe, prompts, T, cross_replace_steps, self_replace_steps)
        Z = T - skip
        w = ef_reverse_process(pipe.unet, sched, xts[:, T - skip], zs[:, :Z], cond, uncond,
                               [source_guidance_scale, target_guidance_scale], eta=eta,
                               control=control, tensors=stack_tensors([tensors]), num_zs=Z)
        imgs = self.decode_image(w[0])
        return self.strip(prompt_src, prompt_tar, image_gt, imgs[0], imgs[1])
