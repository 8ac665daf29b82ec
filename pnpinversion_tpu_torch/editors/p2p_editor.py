"""P2P-family editor (port of ``pnpinversion_tpu/editors/p2p_editor.py``),
with the JAX editor's method-string dispatch:

- ``directinversion+p2p``: DDIM inversion of the source image, one
  (2B-1)-row loop that computes the DirectInversion offsets and the
  controlled edit together, and one batched VAE decode of the reconstruction
  (traj[0], exact by construction) and the edit; its guidance grid
  ``directinversion+p2p_guidance_<inv>_<fwd>`` (CFG inversion) and its
  ablations ``ablation_directinversion_{04,08,interval_<k>,add-target,
  add-source}+p2p`` (the offsets replayed explicitly, then the CFG loops);
- ``null-text-inversion+p2p`` (and its ``_a800``/``_3090`` aliases): DDIM
  inversion, null-text optimisation (per-step Adam on the uncond embedding,
  differentiated through the UNet), then the CFG reconstruction at 2 rows and
  the P2P-controlled edit at 2B rows with the optimised per-step embeddings;
  ``ablation_null-text-inversion_single_branch+p2p`` uses them on the source
  row only;
- ``ddim+p2p``: the same two loops with the plain "" embedding;
- ``negative-prompt-inversion+p2p``: the source prompt's embedding (or its
  slerp toward "", ``npi_interp``) as the uncond embedding;
- ``negative-prompt-inversion+proximal-guidance`` and
  ``null-text-inversion+proximal-guidance``: ProxEdit's shrunk CFG delta in
  the edit loop;
- ``ablation_null-latent-inversion+p2p``: null-text's optimisation turned
  into per-step offsets of the source row.

The result is the 4-panel strip [instruction | ground truth | reconstruction |
edit], uint8 (H, 4W, 3).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pnpinversion_tpu_torch.control.base import NO_CONTROL
from pnpinversion_tpu_torch.control.p2p import (
    P2PControl,
    P2PSpec,
    make_p2p_control,
    stack_tensors,
)
from pnpinversion_tpu_torch.editors.base import Editor
from pnpinversion_tpu_torch.inversion.ddim_inversion import (
    ddim_invert_loop,
    ddim_invert_loop_cfg,
    direct_inversion_offsets,
    make_step_gate,
    null_latent_offsets,
    null_text_optimization,
)
from pnpinversion_tpu_torch.sampling.p2p_forward import (
    fused_direct_inversion_edit_srcfree,
    guidance_forward,
    guidance_forward_single_branch,
    proximal_guidance_forward,
)
from pnpinversion_tpu_torch.utils.text import slerp_tensor

GUIDANCE_GRID = {"0": 0.0, "1": 1.0, "25": 2.5, "5": 5.0, "75": 7.5}
NULL_TEXT_METHODS = ("null-text-inversion+p2p", "null-text-inversion+p2p_a800",
                     "null-text-inversion+p2p_3090")


def direct_inversion_ablation(method: str) -> Optional[dict]:
    """The ``edit_direct_inversion`` options of a DirectInversion ablation
    method string, or None when it is not one."""
    head = method.split("+")[0]
    if method in ("ablation_directinversion_08+p2p", "ablation_directinversion_04+p2p"):
        return {"offset_scale": float(head.split("_")[-1]) / 10}
    if method.startswith("ablation_directinversion_interval_"):
        return {"skip_step": int(head.split("_")[-1])}
    if method == "ablation_directinversion_add-target+p2p":
        return {"offset_rows": "both"}
    if method == "ablation_directinversion_add-source+p2p":
        return {"offset_rows": "source_to_both"}
    return None


def _image(x):
    """One image's array with a leading image axis of 1, or its control
    tensors stacked as one image's (None stays None)."""
    if isinstance(x, dict):
        return stack_tensors([x])
    return None if x is None else x[None]


def offset_rows_mask(offset_rows: str, noise_loss: torch.Tensor) -> tuple:
    """(offsets, row mask (2,)) for ``offset_rows``: 'source' adds the
    offsets to the source row only, 'both' each row's own to each row,
    'source_to_both' the source row's to both rows."""
    ones = torch.ones((2,), dtype=noise_loss.dtype, device=noise_loss.device)
    if offset_rows == "source":
        return noise_loss, torch.tensor([1.0, 0.0], dtype=noise_loss.dtype,
                                        device=noise_loss.device)
    if offset_rows == "source_to_both":
        return noise_loss[..., :1, :, :, :].expand_as(noise_loss), ones
    return noise_loss, ones


class P2PEditor(Editor):
    def __call__(self, edit_method: str, image_path, prompt_src: str, prompt_tar: str,
                 guidance_scale: float = 7.5, proximal: Optional[str] = None,
                 quantile: float = 0.7, use_reconstruction_guidance: bool = False,
                 recon_t: int = 400, recon_lr: float = 0.1, cross_replace_steps: float = 0.4,
                 self_replace_steps: float = 0.6, blend_word=None, eq_params=None,
                 is_replace_controller: bool = False, use_inversion_guidance: bool = False,
                 dilate_mask: int = 1, npi_interp: float = 0.0) -> np.ndarray:
        kw = dict(guidance_scale=guidance_scale, cross_replace_steps=cross_replace_steps,
                  self_replace_steps=self_replace_steps, blend_word=blend_word,
                  eq_params=eq_params, is_replace_controller=is_replace_controller)
        prox_kw = dict(quantile=quantile, use_reconstruction_guidance=use_reconstruction_guidance,
                       recon_t=recon_t, recon_lr=recon_lr,
                       use_inversion_guidance=use_inversion_guidance, dilate_mask=dilate_mask)
        args = (image_path, prompt_src, prompt_tar)
        if edit_method == "ddim+p2p":
            return self.edit_ddim(*args, **kw)
        if edit_method in NULL_TEXT_METHODS:
            return self.edit_null_text(*args, **kw)
        if edit_method == "ablation_null-text-inversion_single_branch+p2p":
            return self.edit_null_text(*args, single_branch=True, **kw)
        if edit_method in ("negative-prompt-inversion+p2p",
                           "negative-prompt-inversion+proximal-guidance"):
            prox = proximal if edit_method.endswith("proximal-guidance") else None
            return self.edit_negative_prompt(*args, proximal=prox, npi_interp=npi_interp,
                                             **prox_kw, **kw)
        if edit_method == "null-text-inversion+proximal-guidance":
            return self.edit_null_text_proximal(*args, proximal=proximal, **prox_kw, **kw)
        if edit_method == "directinversion+p2p":
            return self.edit_direct_inversion(*args, **kw)
        if edit_method.startswith("directinversion+p2p_guidance_"):
            parts = edit_method.split("_")
            return self.edit_direct_inversion(
                *args, inverse_guidance_scale=GUIDANCE_GRID[parts[-2]],
                **{**kw, "guidance_scale": GUIDANCE_GRID[parts[-1]]})
        if edit_method == "ablation_null-latent-inversion+p2p":
            return self.edit_null_latent(*args, **kw)
        ablation = direct_inversion_ablation(edit_method)
        if ablation is not None:
            return self.edit_direct_inversion(*args, **ablation, **kw)
        raise NotImplementedError(f"No edit method named {edit_method}")

    # ------------------------------------------------------------- phases
    def embeds(self, prompts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        cond = self.pipe.encode_prompt(prompts)
        uncond = self.pipe.encode_prompt([""] * len(prompts))
        return cond, uncond

    # The phases take and return one image's arrays (the JAX package's
    # shapes) and run the loops at N = 1: the image axis goes on with
    # ``[None]`` (``_image`` where the argument may be None or the control's
    # tensors) and comes off with ``[0]``.
    def invert(self, latent: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
        """latent (1, h, w, 4), embedding (1, 77, D) -> (T+1, 1, h, w, 4)."""
        return ddim_invert_loop(self.pipe.unet, self.pipe.schedule, latent[None],
                                embedding[None])[0]

    def invert_cfg(self, latent, uncond, cond, guidance_scale) -> torch.Tensor:
        return ddim_invert_loop_cfg(self.pipe.unet, self.pipe.schedule, latent[None],
                                    uncond[None], cond[None], guidance_scale)[0]

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
            self.pipe.unet, self.pipe.schedule, traj[None], cond[None], uncond[None],
            guidance_scale, control, _image(tensors))[0]

    def offsets(self, traj, context, guidance_scale, step_gate) -> torch.Tensor:
        """DirectInversion's offsets (T, B, h, w, 4), replayed explicitly."""
        return direct_inversion_offsets(self.pipe.unet, self.pipe.schedule, traj[None],
                                        context[None], guidance_scale, step_gate)[0][0]

    def null_text(self, traj, uncond, cond, guidance_scale, num_inner_steps=10):
        """Per-step optimised uncond embeddings (T, 1, 77, D); uncond/cond (1, 77, D)."""
        return null_text_optimization(self.pipe.unet, self.pipe.schedule, traj[None],
                                      uncond[None], cond[None], guidance_scale,
                                      num_inner_steps=num_inner_steps)[0]

    def null_latent(self, traj, context, guidance_scale, num_inner_steps=10):
        """The null-latent offsets (T, B, h, w, 4)."""
        return null_latent_offsets(self.pipe.unet, self.pipe.schedule, traj[None],
                                   context[None], guidance_scale,
                                   num_inner_steps=num_inner_steps)[0]

    def guided(self, latent, cond, uncond, guidance_scale, spec=None, tensors=None,
               noise_loss=None, row_mask=None):
        """The CFG loop at 2B rows, P2P-controlled when ``spec`` is given,
        with offsets where ``noise_loss`` and ``row_mask`` are; final latents
        (B, h, w, 4)."""
        control = NO_CONTROL if spec is None else P2PControl(spec)
        return guidance_forward(self.pipe.unet, self.pipe.schedule, latent[None], cond[None],
                                uncond[None], guidance_scale, control, _image(tensors),
                                _image(noise_loss), row_mask)[0]

    def guided_single_branch(self, latent, cond, uncond_steps, uncond, guidance_scale,
                             spec=None, tensors=None):
        control = NO_CONTROL if spec is None else P2PControl(spec)
        return guidance_forward_single_branch(
            self.pipe.unet, self.pipe.schedule, latent[None], cond[None], uncond_steps[None],
            uncond[None], guidance_scale, control, _image(tensors))[0]

    def proximal(self, latent, cond, uncond, guidance_scale, spec=None, tensors=None,
                 image_enc=None, x_stars=None, **kw):
        """``proximal_guidance_forward``; final latents (B, h, w, 4)."""
        control = NO_CONTROL if spec is None else P2PControl(spec)
        return proximal_guidance_forward(
            self.pipe.unet, self.pipe.schedule, latent[None], cond[None], uncond[None],
            guidance_scale, control, _image(tensors), image_enc=_image(image_enc),
            x_stars=_image(x_stars), **kw)[0]

    def _start(self, image_path, prompt_src, prompt_tar, grad: bool = False):
        """The ground-truth image, its latent (1, h, w, 4), the prompts and
        their cond and "" embeddings (2, 77, D); ``grad``: embeddings cloned
        out of inference mode, for the phases that differentiate."""
        image_gt = self.load(image_path)
        prompts = [prompt_src, prompt_tar]
        cond, uncond = self.embeds(prompts)
        if grad:
            cond, uncond = cond.clone(), uncond.clone()
        return image_gt, self.encode_image(image_gt), prompts, cond, uncond

    def _finish(self, prompts, image_gt, recon, edit) -> np.ndarray:
        """Decode the reconstruction (1, h, w, 4) and the edit's last row in
        one batched VAE call; the strip."""
        both = self.decode_image(torch.cat([recon, edit[-1:]], dim=0))
        return self.strip(prompts[0], prompts[1], image_gt, both[0], both[1])

    # ------------------------------------------------------------- methods
    @torch.inference_mode()
    def edit_direct_inversion(self, image_path, prompt_src, prompt_tar, guidance_scale=7.5,
                              inverse_guidance_scale=None, cross_replace_steps=0.4,
                              self_replace_steps=0.6, blend_word=None, eq_params=None,
                              is_replace_controller=False, offset_scale=1.0, skip_step=1,
                              offset_rows="source", fast_recon=True, fused=True) -> np.ndarray:
        """directinversion+p2p and its ablations. With full offsets (scale 1,
        no skip) the reconstruction is traj[0] exactly (``fast_recon``) and,
        offsets on the source row only, the offsets and the edit run as one
        fused loop (``fused``); otherwise the offsets are replayed first and
        the CFG loops take them (``offset_rows``: which rows get them)."""
        image_gt, latent, prompts, cond, uncond = self._start(image_path, prompt_src, prompt_tar)
        if inverse_guidance_scale is None:
            traj = self.invert(latent, cond[:1])
        else:
            traj = self.invert_cfg(latent, uncond[:1], cond[:1], inverse_guidance_scale)
        spec, tensors = self.make_control(prompts, cross_replace_steps, self_replace_steps,
                                          blend_word, eq_params, is_replace_controller)
        use_fast_recon = fast_recon and offset_scale == 1.0 and skip_step == 1
        if fused and offset_rows == "source" and use_fast_recon:
            edit = self.fused_edit(spec, traj, cond, uncond, guidance_scale, tensors)
            return self._finish(prompts, image_gt, traj[0], edit)
        gate = make_step_gate(self.pipe.schedule.num_steps, offset_scale, skip_step)
        noise_loss, row_mask = offset_rows_mask(offset_rows, self.offsets(
            traj, torch.cat([uncond, cond], dim=0), guidance_scale, gate))
        x_t = traj[-1]
        recon = traj[0] if use_fast_recon else self.guided(
            x_t, cond, uncond, guidance_scale, noise_loss=noise_loss, row_mask=row_mask)[:1]
        edit = self.guided(x_t, cond, uncond, guidance_scale, spec, tensors, noise_loss, row_mask)
        return self._finish(prompts, image_gt, recon, edit)

    def _recon_and_edit(self, prompts, image_gt, traj, cond, uncond_recon, uncond_edit,
                        guidance_scale, control_kw) -> np.ndarray:
        """The CFG reconstruction of the source row and the P2P edit, both from
        traj[-1], decoded in one batched VAE call."""
        x_t = traj[-1]
        recon = self.guided(x_t, cond[:1], uncond_recon, guidance_scale)
        spec, tensors = self.make_control(prompts, **control_kw)
        edit = self.guided(x_t, cond, uncond_edit, guidance_scale, spec, tensors)
        return self._finish(prompts, image_gt, recon, edit)

    @torch.inference_mode()
    def edit_ddim(self, image_path, prompt_src, prompt_tar, guidance_scale=7.5,
                  **control_kw) -> np.ndarray:
        """ddim+p2p: plain DDIM inversion and the "" uncond embedding."""
        image_gt, latent, prompts, cond, uncond = self._start(image_path, prompt_src, prompt_tar)
        traj = self.invert(latent, cond[:1])
        return self._recon_and_edit(prompts, image_gt, traj, cond, uncond[:1], uncond,
                                    guidance_scale, control_kw)

    @torch.no_grad()
    def edit_null_text(self, image_path, prompt_src, prompt_tar, guidance_scale=7.5,
                       num_inner_steps=10, single_branch=False, **control_kw) -> np.ndarray:
        """null-text-inversion+p2p; ``single_branch``: the ablation that uses
        the optimised embeddings on the source row only. Not in inference
        mode: the null-text phase differentiates through the UNet (its inner
        loop turns grad on), so the embeddings, made in inference mode, are
        cloned into normal tensors."""
        image_gt, latent, prompts, cond, uncond = self._start(image_path, prompt_src, prompt_tar,
                                                              grad=True)
        traj = self.invert(latent, cond[:1])
        uncond_steps = self.null_text(traj, uncond[:1], cond[:1], guidance_scale,
                                      num_inner_steps)
        if not single_branch:
            return self._recon_and_edit(prompts, image_gt, traj, cond, uncond_steps,
                                        uncond_steps, guidance_scale, control_kw)
        x_t = traj[-1]
        recon = self.guided_single_branch(x_t, cond[:1], uncond_steps, uncond[:1],
                                          guidance_scale)
        spec, tensors = self.make_control(prompts, **control_kw)
        edit = self.guided_single_branch(x_t, cond, uncond_steps, uncond, guidance_scale, spec,
                                         tensors)
        return self._finish(prompts, image_gt, recon, edit)

    def _proximal_recon_and_edit(self, prompts, image_gt, latent, traj, cond, uncond_recon,
                                 uncond_edit, guidance_scale, proximal, quantile,
                                 use_reconstruction_guidance, recon_t, recon_lr,
                                 use_inversion_guidance, dilate_mask, control_kw) -> np.ndarray:
        """ProxEdit's plain CFG reconstruction of the source row and its
        shrunk-delta edit, both from traj[-1]."""
        x_t = traj[-1]
        recon = self.proximal(x_t, cond[:1], uncond_recon, guidance_scale, edit_stage=False,
                              quantile=quantile, recon_lr=recon_lr, recon_t=recon_t,
                              dilate_mask=dilate_mask)
        spec, tensors = self.make_control(prompts, **control_kw)
        guide = use_reconstruction_guidance or use_inversion_guidance
        edit = self.proximal(
            x_t, cond, uncond_edit, guidance_scale, spec, tensors, edit_stage=True,
            prox=proximal, quantile=quantile, recon_lr=recon_lr if guide else 0.0,
            recon_t=recon_t if guide else 1000, inversion_guidance=use_inversion_guidance,
            image_enc=latent if use_reconstruction_guidance else None, x_stars=traj,
            dilate_mask=dilate_mask)
        return self._finish(prompts, image_gt, recon, edit)

    @torch.inference_mode()
    def edit_negative_prompt(self, image_path, prompt_src, prompt_tar, guidance_scale=7.5,
                             proximal=None, quantile=0.7, use_reconstruction_guidance=False,
                             recon_t=400, recon_lr=0.1, npi_interp=0.0, cross_replace_steps=0.4,
                             self_replace_steps=0.6, blend_word=None, eq_params=None,
                             is_replace_controller=False, use_inversion_guidance=False,
                             dilate_mask=1) -> np.ndarray:
        """negative-prompt-inversion (+proximal-guidance with ``proximal``):
        plain DDIM inversion, and the source prompt's embedding as the uncond
        one (slerped toward "" by ``npi_interp``)."""
        image_gt, latent, prompts, cond, uncond = self._start(image_path, prompt_src, prompt_tar)
        traj = self.invert(latent, cond[:1])
        fake_uncond = cond[:1]
        if npi_interp > 0.0:
            fake_uncond = torch.as_tensor(slerp_tensor(
                npi_interp, cond[:1].float().cpu().numpy(), uncond[:1].float().cpu().numpy()),
                device=cond.device).to(cond.dtype)
        return self._proximal_recon_and_edit(
            prompts, image_gt, latent, traj, cond, fake_uncond, fake_uncond.expand_as(cond),
            guidance_scale, proximal, quantile, use_reconstruction_guidance, recon_t, recon_lr,
            use_inversion_guidance, dilate_mask,
            dict(cross_replace_steps=cross_replace_steps, self_replace_steps=self_replace_steps,
                 blend_word=blend_word, eq_params=eq_params,
                 is_replace_controller=is_replace_controller))

    @torch.no_grad()
    def edit_null_text_proximal(self, image_path, prompt_src, prompt_tar, guidance_scale=7.5,
                                proximal=None, quantile=0.7, use_reconstruction_guidance=False,
                                recon_t=400, recon_lr=0.1, cross_replace_steps=0.4,
                                self_replace_steps=0.6, blend_word=None, eq_params=None,
                                is_replace_controller=False, use_inversion_guidance=False,
                                dilate_mask=1, num_inner_steps=10) -> np.ndarray:
        """null-text-inversion+proximal-guidance: null-text's per-step
        embeddings in ProxEdit's loops."""
        image_gt, latent, prompts, cond, uncond = self._start(image_path, prompt_src, prompt_tar,
                                                              grad=True)
        traj = self.invert(latent, cond[:1])
        uncond_steps = self.null_text(traj, uncond[:1], cond[:1], guidance_scale,
                                      num_inner_steps)
        return self._proximal_recon_and_edit(
            prompts, image_gt, latent, traj, cond, uncond_steps, uncond_steps, guidance_scale,
            proximal, quantile, use_reconstruction_guidance, recon_t, recon_lr,
            use_inversion_guidance, dilate_mask,
            dict(cross_replace_steps=cross_replace_steps, self_replace_steps=self_replace_steps,
                 blend_word=blend_word, eq_params=eq_params,
                 is_replace_controller=is_replace_controller))

    @torch.no_grad()
    def edit_null_latent(self, image_path, prompt_src, prompt_tar, guidance_scale=7.5,
                         num_inner_steps=10, **control_kw) -> np.ndarray:
        """ablation_null-latent-inversion+p2p: the null-latent offsets on the
        source row of both CFG loops."""
        image_gt, latent, prompts, cond, uncond = self._start(image_path, prompt_src, prompt_tar,
                                                              grad=True)
        traj = self.invert(latent, cond[:1])
        noise_loss, row_mask = offset_rows_mask("source", self.null_latent(
            traj, torch.cat([uncond, cond], dim=0), guidance_scale, num_inner_steps))
        x_t = traj[-1]
        recon = self.guided(x_t, cond, uncond, guidance_scale, noise_loss=noise_loss,
                            row_mask=row_mask)[:1]
        spec, tensors = self.make_control(prompts, **control_kw)
        edit = self.guided(x_t, cond, uncond, guidance_scale, spec, tensors, noise_loss, row_mask)
        return self._finish(prompts, image_gt, recon, edit)
