"""MasaCtrl editor (port of ``pnpinversion_tpu/editors/masactrl_editor.py``).

Methods:

- ``ddim+masactrl``: DDIM inversion with the empty prompt, then one CFG
  sampling loop over ["", target] under mutual self-attention control; the
  loop's source row is the reconstruction panel;
- ``directinversion+masactrl``: the same inversion and loop with
  DirectInversion's offsets on the source row. The control never changes
  the source row (target queries borrow the source's K/V, the source attends
  as usual), so the loop's own source row gives the offsets: the fused loop
  of ``sampling/p2p_forward.py`` with row mask [1, 0] and a gate of ones.

The result is the strip [instruction | ground truth | source row | target
row], uint8 (H, 4W, 3).
"""
from __future__ import annotations

import numpy as np
import torch

from pnpinversion_tpu_torch.control.masactrl import MasaCtrlControl, MasaCtrlSpec
from pnpinversion_tpu_torch.editors.base import Editor
from pnpinversion_tpu_torch.inversion.ddim_inversion import ddim_invert_loop
from pnpinversion_tpu_torch.sampling.p2p_forward import (
    fused_direct_inversion_edit,
    guidance_forward,
)

METHODS = ("ddim+masactrl", "directinversion+masactrl")


class MasaCtrlEditor(Editor):
    def __call__(self, edit_method, image_path, prompt_src, prompt_tar, guidance_scale=7.5,
                 step=4, layper=10) -> np.ndarray:
        if edit_method == "ddim+masactrl":
            return self.edit_ddim(image_path, prompt_src, prompt_tar, guidance_scale, step,
                                  layper)
        if edit_method == "directinversion+masactrl":
            return self.edit_direct_inversion(image_path, prompt_src, prompt_tar,
                                              guidance_scale, step, layper)
        raise NotImplementedError(f"No edit method named {edit_method}")

    def _start(self, image_path, prompt_tar):
        """The ground-truth image, the DDIM inversion of its latent under the
        empty prompt (T+1, 1, h, w, 4), the cond ["", target] and uncond
        ["", ""] embeddings (2, 77, D)."""
        pipe = self.pipe
        image_gt = self.load(image_path)
        cond = pipe.encode_prompt(["", prompt_tar])
        uncond = pipe.encode_prompt(["", ""])
        traj = ddim_invert_loop(pipe.unet, pipe.schedule, self.encode_image(image_gt)[None],
                                cond[None, :1])[0]
        return image_gt, traj, cond, uncond

    def _finish(self, prompt_src, prompt_tar, image_gt, latents) -> np.ndarray:
        imgs = self.decode_image(latents)
        return self.strip(prompt_src, prompt_tar, image_gt, imgs[0], imgs[-1])

    @torch.inference_mode()
    def edit_ddim(self, image_path, prompt_src, prompt_tar, guidance_scale=7.5, step=4,
                  layper=10) -> np.ndarray:
        image_gt, traj, cond, uncond = self._start(image_path, prompt_tar)
        control = MasaCtrlControl(MasaCtrlSpec(start_step=step, start_layer=layper))
        latents = guidance_forward(self.pipe.unet, self.pipe.schedule, traj[None, -1],
                                   cond[None], uncond[None], guidance_scale, control, {})[0]
        return self._finish(prompt_src, prompt_tar, image_gt, latents)

    @torch.inference_mode()
    def edit_direct_inversion(self, image_path, prompt_src, prompt_tar, guidance_scale=7.5,
                              step=4, layper=10) -> np.ndarray:
        pipe = self.pipe
        image_gt, traj, cond, uncond = self._start(image_path, prompt_tar)
        control = MasaCtrlControl(MasaCtrlSpec(start_step=step, start_layer=layper))
        row_mask = torch.tensor([1.0, 0.0], dtype=pipe.dtype, device=pipe.device)
        latents = fused_direct_inversion_edit(
            pipe.unet, pipe.schedule, traj[None], cond[None], uncond[None], guidance_scale,
            control, {}, row_mask, np.ones((pipe.schedule.num_steps,), np.float32))[0]
        return self._finish(prompt_src, prompt_tar, image_gt, latents)
