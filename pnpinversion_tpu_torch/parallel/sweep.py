"""Batched editing: N images as one leading batch on one GPU (port of
``pnpinversion_tpu/parallel/sweep.py``'s ``BatchedDirectInversionP2P``,
``BatchedMasaCtrl``, ``BatchedPnP``, ``BatchedEditFriendly``, ``BatchedEDICT``,
``BatchedInstruct``, ``BatchedBLD``, ``BatchedPix2PixZero`` and
``BatchedStyleDiffusion``, without their device mesh).

Where the JAX package ``vmap``s a one-image pipeline over an image axis and
shards it over a mesh, here the N images' UNet rows go through one UNet call
(image-major, see ``models.unet.apply_images``), so every UNet call and every
flash launch covers the whole batch. The one-image loops are the N = 1 case
of the same functions, so the two paths run the same code.

Pattern::

  sweep = BatchedDirectInversionP2P(pipe)
  recon, edit = sweep.edit_batch(spec, images_u8, cond, uncond, 7.5,
                                 stack_tensors(per_image_tensors))

Images whose controller spec differs (replace or refine, blend on or off) run
in different batches; ``group_items_by_spec`` buckets them first.

Every class takes ``tp_group``: the ranks of a tensor-parallel group
(``parallel/tensor_parallel.py``) split the pipeline's UNet, VAE and text
tower (and StyleDiffusion's CLIP tower) by output columns once, and run the
same images; every rank returns the whole results.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pnpinversion_tpu_torch.control.base import NO_CONTROL
from pnpinversion_tpu_torch.control.edict_p2p import EdictP2PControl
from pnpinversion_tpu_torch.control.masactrl import MasaCtrlControl, MasaCtrlSpec
from pnpinversion_tpu_torch.control.p2p import P2PControl, P2PSpec
from pnpinversion_tpu_torch.control.pnp import make_pnp_control
from pnpinversion_tpu_torch.editors.bld_editor import bld_sample
from pnpinversion_tpu_torch.editors.edict_editor import METHODS as EDICT_METHODS
from pnpinversion_tpu_torch.editors.edict_editor import (
    GUIDANCE_SCALE,
    INIT_IMAGE_STRENGTH,
    PRECISIONS,
    RECON_GUIDANCE_SCALE,
    coupled_scan,
)
from pnpinversion_tpu_torch.editors.instruct_editor import VARIANTS as INSTRUCT_VARIANTS
from pnpinversion_tpu_torch.editors.instruct_editor import instruct_sample
from pnpinversion_tpu_torch.editors.p2p_editor import (
    GUIDANCE_GRID,
    direct_inversion_ablation,
    offset_rows_mask,
)
from pnpinversion_tpu_torch.editors.pix2pix_zero_editor import METHODS as P2Z_METHODS
from pnpinversion_tpu_torch.editors.pix2pix_zero_editor import XA_GUIDANCE, p2z_latents
from pnpinversion_tpu_torch.editors.pnp_editor import METHODS as PNP_METHODS
from pnpinversion_tpu_torch.editors.pnp_editor import (
    NEGATIVE_PROMPT,
    ddim_sample_trajectory,
    pnp_sample_loop,
)
from pnpinversion_tpu_torch.editors.stylediffusion_editor import (
    CLIP_VIT_B16,
    TAUS,
    make_clip_vision,
    stylediffusion_latents,
)
from pnpinversion_tpu_torch.inversion.ddim_inversion import (
    ddim_invert_loop,
    ddim_invert_loop_cfg,
    direct_inversion_offsets,
    make_step_gate,
    null_latent_offsets,
    null_text_optimization,
)
from pnpinversion_tpu_torch.inversion.ef_ddpm import ef_forward_process, ef_reverse_process
from pnpinversion_tpu_torch.models.vae import image_to_latent, latent_to_image, to_host
from pnpinversion_tpu_torch.parallel.tensor_parallel import shard_columns_, shard_pipeline_
from pnpinversion_tpu_torch.pipeline import SDPipeline
from pnpinversion_tpu_torch.sampling.p2p_forward import (
    fused_direct_inversion_edit,
    fused_direct_inversion_edit_srcfree,
    guidance_forward,
    guidance_forward_single_branch,
    proximal_guidance_forward,
)
from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule
from pnpinversion_tpu_torch.utils.observability import host_sync


def group_items_by_spec(items: Sequence[dict],
                        keyfn: Callable[[dict], Any]) -> Dict[Any, List[dict]]:
    groups: Dict[Any, List[dict]] = {}
    for it in items:
        groups.setdefault(keyfn(it), []).append(it)
    return groups


def pad_batch(arrays: List[np.ndarray], multiple: int) -> Tuple[np.ndarray, int]:
    """Stack and pad the leading axis up to a multiple (repeating the last
    element); returns (batch, real_count)."""
    n = len(arrays)
    padded = list(arrays) + [arrays[-1]] * ((-n) % multiple)
    return np.stack(padded), n


def _shard(pipe: SDPipeline, tp_group) -> SDPipeline:
    """The pipeline, split over ``tp_group`` once where one is given."""
    if tp_group is not None:
        shard_pipeline_(pipe, tp_group)
    return pipe


def _cached_embed(obj, prompts) -> torch.Tensor:
    """The embeddings of constant prompts ("" and so on), encoded once per
    batched instance."""
    key = tuple(prompts)
    if key not in obj._cache:
        obj._cache[key] = obj.pipe.encode_prompt(list(prompts))
    return obj._cache[key]


def _encode_images(pipe: SDPipeline, images_u8, dtype=None) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> latents (N, 1, h, w, 4), encoded in ``dtype``
    (the pipeline's by default)."""
    host_sync("images", pipe.device)
    images = torch.as_tensor(np.ascontiguousarray(images_u8), device=pipe.device)
    return image_to_latent(pipe.vae, images, dtype=dtype or pipe.dtype)[:, None]


def _decode_pair(pipe: SDPipeline, a: torch.Tensor, b: torch.Tensor):
    """Latents a and b (N, h, w, 4) decoded in one VAE call, in their dtype:
    uint8 (N, H, W, 3) each, on the host."""
    n = a.shape[0]
    both = to_host(latent_to_image(pipe.vae, torch.cat([a, b])))
    return both[:n], both[n:]


NULL_TEXT = "null-text-inversion+p2p"
SINGLE_BRANCH = "ablation_null-text-inversion_single_branch+p2p"
NULL_LATENT = "ablation_null-latent-inversion+p2p"


class BatchedDirectInversionP2P:
    """P2P-family inversion variants and ablations over a batch of images.

    The per-image pipelines are the editor's (``editors/p2p_editor.py``).
    The controller never changes the source row of the edit loop (P2P edits
    the target rows; LocalBlend blends them toward row 0), so the edit loop's
    row 0 is the reconstruction pass, and each method runs one controlled
    loop per batch with no separate reconstruction (decode(traj[0]) for the
    full-offset DirectInversion methods), except ProxEdit, whose shrunk delta
    moves row 0 as well. The ``uncond`` input is per image, so
    negative-prompt inversion feeds its "fake uncond" (the source prompt's
    embedding, possibly slerped) through the same loops as ddim+p2p.
    """

    VARIANTS = ("directinversion+p2p", "ddim+p2p",
                "negative-prompt-inversion+p2p", NULL_TEXT,
                "negative-prompt-inversion+proximal-guidance",
                "null-text-inversion+proximal-guidance")

    ABLATIONS = ("ablation_directinversion_04+p2p",
                 "ablation_directinversion_08+p2p",
                 "ablation_directinversion_add-source+p2p",
                 "ablation_directinversion_add-target+p2p",
                 NULL_LATENT, SINGLE_BRANCH)

    @classmethod
    def supports(cls, method: str) -> bool:
        """True for the fixed variants plus the guidance grid
        (directinversion+p2p_guidance_<inv>_<fwd>) and the ablations
        (including interval_<k> and step_<n>)."""
        return (method in cls.VARIANTS or method in cls.ABLATIONS
                or method.startswith("directinversion+p2p_guidance_")
                or method.startswith("ablation_directinversion_interval_")
                or cls.step_ablation_steps(method) is not None)

    @staticmethod
    def step_ablation_steps(method: str) -> Optional[int]:
        """The step-count ablation: the method is plain directinversion+p2p on
        a pipeline created with num_ddim_steps=<n> (the output folder keeps
        the ablation's name)."""
        m = re.fullmatch(r"ablation_directinversion_step_(\d+)\+p2p", method)
        return int(m.group(1)) if m else None

    def __init__(self, pipe: SDPipeline, num_inner_steps: int = 10, proximal: str = "l0",
                 quantile: float = 0.75, recon_lr: float = 1.0, recon_t: int = 400,
                 dilate_mask: int = 1, tp_group=None):
        self.pipe = _shard(pipe, tp_group)
        self.num_inner_steps = num_inner_steps  # null-text's Adam inner steps
        # ProxEdit's benchmark settings: l0, quantile 0.75, inversion
        # guidance, recon_lr 1, recon_t 400
        self.prox = dict(prox=proximal, quantile=quantile, recon_lr=recon_lr, recon_t=recon_t,
                         dilate_mask=dilate_mask)

    def edit_batch(self, spec: P2PSpec, images_u8, cond: torch.Tensor, uncond: torch.Tensor,
                   guidance_scale: float, tensors: Dict[str, torch.Tensor],
                   method: str = "directinversion+p2p") -> Tuple[np.ndarray, np.ndarray]:
        """images_u8 (N, H, W, 3) uint8; cond (N, 2, 77, D); uncond (2, 77, D)
        shared or (N, 2, 77, D) per image; tensors: each image's control
        tensors stacked on a leading N axis (``control.p2p.stack_tensors``).
        Returns (recon, edit), uint8 (N, H, W, 3) on the host."""
        if not self.supports(method):
            raise NotImplementedError(f"{method!r} is not a batched P2P method")
        if self.step_ablation_steps(method) is not None:
            method = "directinversion+p2p"
        pipe = self.pipe
        N = len(images_u8)
        if uncond.dim() == 3:
            uncond = uncond[None].expand((N,) + uncond.shape)
        grad = method in (NULL_TEXT, SINGLE_BRANCH, NULL_LATENT,
                          "null-text-inversion+proximal-guidance")
        with torch.no_grad() if grad else torch.inference_mode():
            # clones: the loops that differentiate cannot take inference tensors
            cond, uncond = cond.to(pipe.device).clone(), uncond.to(pipe.device).clone()
            recon, edit = self._latents(spec, _encode_images(pipe, images_u8), cond, uncond,
                                        guidance_scale, tensors, method)
            return _decode_pair(pipe, recon[:, 0], edit[:, -1])

    def _latents(self, spec, latent, cond, uncond, g, tensors, method):
        """(recon (N, 1, h, w, 4), edit rows (N, 2, h, w, 4)) of a method;
        latent (N, 1, h, w, 4)."""
        pipe = self.pipe
        unet, sched = pipe.unet, pipe.schedule
        control = P2PControl(spec)
        if method.startswith("directinversion+p2p_guidance_"):
            traj = ddim_invert_loop_cfg(unet, sched, latent, uncond[:, :1], cond[:, :1],
                                        GUIDANCE_GRID[method.split("_")[-2]])
        else:
            traj = ddim_invert_loop(unet, sched, latent, cond[:, :1])
        x_t = traj[:, -1]
        if method.startswith("ablation_"):
            if method == SINGLE_BRANCH:
                uncond_steps = self._null_text(traj, uncond, cond, g)
                rows = guidance_forward_single_branch(unet, sched, x_t, cond, uncond_steps,
                                                      uncond, g, control, tensors)
                return rows[:, :1], rows
            context = torch.cat([uncond, cond], dim=1)
            if method == NULL_LATENT:
                noise_loss, row_mask = offset_rows_mask("source", null_latent_offsets(
                    unet, sched, traj, context, g, num_inner_steps=self.num_inner_steps))
            else:
                opts = direct_inversion_ablation(method)
                gate = make_step_gate(sched.num_steps, opts.get("offset_scale", 1.0),
                                      opts.get("skip_step", 1))
                noise_loss, row_mask = offset_rows_mask(
                    opts.get("offset_rows", "source"),
                    direct_inversion_offsets(unet, sched, traj, context, g, gate)[0])
            rows = guidance_forward(unet, sched, x_t, cond, uncond, g, control, tensors,
                                    noise_loss, row_mask)
            return rows[:, :1], rows
        if method.endswith("proximal-guidance"):
            if method.startswith("null-text"):
                unc = unc_recon = self._null_text(traj, uncond, cond, g)
            else:
                unc, unc_recon = uncond, uncond[:, :1]
            recon = proximal_guidance_forward(unet, sched, x_t, cond[:, :1], unc_recon, g,
                                              NO_CONTROL, None, edit_stage=False,
                                              **{**self.prox, "prox": None})
            rows = proximal_guidance_forward(unet, sched, x_t, cond, unc, g, control, tensors,
                                             edit_stage=True, inversion_guidance=True,
                                             x_stars=traj, **self.prox)
            return recon, rows
        if method == NULL_TEXT:
            rows = guidance_forward(unet, sched, x_t, cond, self._null_text(traj, uncond, cond, g),
                                    g, control, tensors)
            return rows[:, :1], rows
        if method.startswith("directinversion+p2p"):
            # full offsets: the source row re-snaps to the trajectory, so the
            # dead uncond-source UNet row is dropped (2B-1 rows per image)
            srcfree = P2PControl(dataclasses.replace(spec, uncond_rows=spec.batch_size - 1))
            rows = fused_direct_inversion_edit_srcfree(unet, sched, traj, cond, uncond, g,
                                                       srcfree, tensors)
            return traj[:, 0], rows
        # ddim+p2p and negative-prompt-inversion+p2p: no offsets
        row_mask = torch.zeros((spec.batch_size,), dtype=pipe.dtype, device=pipe.device)
        rows = fused_direct_inversion_edit(unet, sched, traj, cond, uncond, g, control, tensors,
                                           row_mask, np.ones((sched.num_steps,), np.float32))
        return rows[:, :1], rows

    def _null_text(self, traj, uncond, cond, g):
        """Per-image per-step optimised uncond embeddings (N, T, 1, 77, D)."""
        return null_text_optimization(self.pipe.unet, self.pipe.schedule, traj, uncond[:, :1],
                                      cond[:, :1], g, num_inner_steps=self.num_inner_steps)


class BatchedMasaCtrl:
    """MasaCtrl (ddim+ and directinversion+) over a batch of images.

    The per-image pipeline is the editor's (``editors/masactrl_editor.py``):
    inversion with the empty prompt, then one 2-prompt sampling loop under
    mutual self-attention control, with DirectInversion's offsets on the
    source row (``use_offsets``) or without (ddim+: a zero row mask, the
    plain CFG loop).
    """

    def __init__(self, pipe: SDPipeline, start_step: int = 4, start_layer: int = 10,
                 tp_group=None):
        self.pipe = _shard(pipe, tp_group)
        self.start_step = start_step
        self.start_layer = start_layer
        self._cache: Dict[Any, Any] = {}

    @torch.inference_mode()
    def edit_batch(self, use_offsets: bool, images_u8, cond: torch.Tensor,
                   guidance_scale: float) -> Tuple[np.ndarray, np.ndarray]:
        """images_u8 (N, H, W, 3) uint8; cond (N, 2, 77, D) = ["", target].
        Returns (source row, target row) images, uint8 (N, H, W, 3) each."""
        pipe = self.pipe
        unet, sched = pipe.unet, pipe.schedule
        latent = _encode_images(pipe, images_u8)
        cond = cond.to(pipe.device)
        N = cond.shape[0]
        uncond = _cached_embed(self, ["", ""])[None].expand(N, -1, -1, -1)
        traj = ddim_invert_loop(unet, sched, latent, cond[:, :1])
        control = MasaCtrlControl(MasaCtrlSpec(start_step=self.start_step,
                                               start_layer=self.start_layer))
        row_mask = torch.tensor([1.0 if use_offsets else 0.0, 0.0], dtype=pipe.dtype,
                                device=pipe.device)
        lat = fused_direct_inversion_edit(unet, sched, traj, cond, uncond, guidance_scale,
                                          control, {}, row_mask,
                                          np.ones((sched.num_steps,), np.float32))
        return _decode_pair(pipe, lat[:, 0], lat[:, 1])


class BatchedPnP:
    """Plug-and-Play (ddim+ and directinversion+) over a batch of images;
    the per-image pipeline is the editor's (``editors/pnp_editor.py``), with
    its ``steps_offset=1`` schedule."""

    METHODS = PNP_METHODS

    def __init__(self, pipe: SDPipeline, steps_offset: int = 1, tp_group=None):
        self.pipe = _shard(pipe, tp_group)
        self.schedule = make_ddim_schedule(num_steps=pipe.schedule.num_steps,
                                           steps_offset=steps_offset)
        self._cache: Dict[Any, Any] = {}

    @torch.inference_mode()
    def edit_batch(self, method: str, images_u8, cond_src: torch.Tensor,
                   cond_tar: torch.Tensor, guidance_scale: float) -> Tuple[np.ndarray, np.ndarray]:
        """images_u8 (N, H, W, 3) uint8; cond_src/cond_tar (N, 1, 77, D).
        Returns (recon, edit), uint8 (N, H, W, 3) each."""
        if method not in self.METHODS:
            raise NotImplementedError(f"{method!r} is not a batched PnP method")
        pipe, sched = self.pipe, self.schedule
        unet = pipe.unet
        cond_src, cond_tar = cond_src.to(pipe.device), cond_tar.to(pipe.device)
        N = cond_src.shape[0]
        traj = ddim_invert_loop(unet, sched, _encode_images(pipe, images_u8), cond_src)
        fixed = _cached_embed(self, ["", NEGATIVE_PROMPT])[None].expand(N, -1, -1, -1)
        embeds = torch.cat([fixed, cond_tar], dim=1)
        control = make_pnp_control(pipe.config.unet, sched.num_steps)
        if method == "ddim+pnp":
            src_traj = ddim_sample_trajectory(unet, sched, traj[:, -1], cond_src)
            recon = src_traj[:, -1]
            edited = pnp_sample_loop(unet, sched, control, src_traj, src_traj[:, 0], embeds,
                                     guidance_scale)
        else:  # directinversion+pnp
            recon = traj[:, 1]
            edited = pnp_sample_loop(unet, sched, control, traj.flip(1)[:, :-1], traj[:, -1],
                                     embeds, guidance_scale)
        return _decode_pair(pipe, recon[:, 0], edited[:, 0])


class BatchedEditFriendly:
    """edit-friendly-inversion+p2p over a batch of images; the per-image
    pipeline is the editor's (``editors/ef_editor.py``). The images share
    one noise draw from ``seed`` (as the JAX class gives them one key), so
    each image is its single-image edit. Images whose P2P spec differs
    (Replace when the word counts match, else Refine) run in different
    batches: ``group_items_by_spec``. The UNet and the decode compute in
    f32, as in the editor."""

    def __init__(self, pipe: SDPipeline, eta: float = 1.0, skip: int = 12,
                 steps_offset: int = 1, seed: int = 1234, tp_group=None):
        self.pipe = _shard(pipe, tp_group)
        self.schedule = make_ddim_schedule(num_steps=pipe.schedule.num_steps,
                                           steps_offset=steps_offset)
        self.eta = eta
        self.skip = min(skip, self.schedule.num_steps - 1)
        self.seed = seed
        self._cache: Dict[Any, Any] = {}

    @torch.inference_mode()
    def edit_batch(self, spec: P2PSpec, images_u8, cond: torch.Tensor,
                   source_guidance_scale: float = 1.0, target_guidance_scale: float = 7.5,
                   tensors: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """images_u8 (N, H, W, 3) uint8; cond (N, 2, 77, D) = [source,
        target]; tensors: each image's P2P tensors stacked on a leading N
        axis. Returns (source row, target row) images, uint8 (N, H, W, 3)
        each: the strip's reconstruction panel is the edit pass's source
        row."""
        pipe, sched = self.pipe, self.schedule
        T, Z = sched.num_steps, sched.num_steps - self.skip
        cond = cond.to(pipe.device)
        N = cond.shape[0]
        uncond = _cached_embed(self, ["", ""])[None].expand(N, -1, -1, -1)
        gen = torch.Generator(device=pipe.device).manual_seed(self.seed)
        zs, xts = ef_forward_process(pipe.unet, sched, _encode_images(pipe, images_u8),
                                     cond[:, :1], uncond[:, :1], source_guidance_scale, gen,
                                     eta=self.eta)
        w = ef_reverse_process(pipe.unet, sched, xts[:, T - self.skip], zs[:, :Z], cond, uncond,
                               [source_guidance_scale, target_guidance_scale], eta=self.eta,
                               control=P2PControl(spec), tensors=tensors, num_zs=Z)
        return _decode_pair(pipe, w[:, 0], w[:, 1])


class BatchedEDICT:
    """EDICT (``edict+direct_forward``, ``edict+p2p``) over a batch of
    images; the per-image pipeline is the editor's
    (``editors/edict_editor.py``): the strength-1.0 round trip at guidance 7
    for the reconstruction, the strength-0.8 one at guidance 3 for the edit.
    The UNet and the VAE compute in f32 on the pipeline's weights, with the
    embeddings cast to f32; the latent pair is f32 or float64
    (``precision``)."""

    METHODS = EDICT_METHODS

    def __init__(self, pipe: SDPipeline, precision: str = "f32", tp_group=None):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.pipe = _shard(pipe, tp_group)
        self.precision = precision
        self.schedule = make_ddim_schedule(num_steps=pipe.schedule.num_steps)
        self._cache: Dict[Any, Any] = {}

    @torch.inference_mode()
    def edit_batch(self, method: str, images_u8, cond_src: torch.Tensor, cond_tar: torch.Tensor,
                   tensors: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """images_u8 (N, H, W, 3) uint8; cond_src/cond_tar (N, 1, 77, D);
        tensors: each image's ``make_edict_p2p_tensors`` stacked on a leading
        N axis (``edict+p2p`` only). Returns (recon, edit), uint8
        (N, H, W, 3) each."""
        if method not in self.METHODS:
            raise NotImplementedError(f"{method!r} is not an EDICT method")
        pipe, sched = self.pipe, self.schedule
        T = sched.num_steps
        t_limit = T - int(T * INIT_IMAGE_STRENGTH)
        cond_src, cond_tar = (c.to(pipe.device, torch.float32) for c in (cond_src, cond_tar))
        N = cond_src.shape[0]
        uncond = _cached_embed(self, [""]).float()[None].expand(N, -1, -1, -1)
        ctx_src = torch.cat([uncond, cond_src], dim=1)
        latent = _encode_images(pipe, images_u8, torch.float32)
        pair0 = torch.cat([latent, latent], dim=1)

        def round_trip(ctx_out, g, lim, **kw):
            inv = coupled_scan(pipe.unet, sched, pair0, ctx_src, g, lim, True,
                               precision=self.precision)
            return coupled_scan(pipe.unet, sched, inv, ctx_out, g, lim, False,
                                precision=self.precision, **kw)

        rec = round_trip(ctx_src, RECON_GUIDANCE_SCALE, 0)
        if method == "edict+p2p":
            out = round_trip(ctx_src, GUIDANCE_SCALE, t_limit, control=EdictP2PControl(T),
                             tensors=tensors, edit_context=cond_tar)
        else:
            out = round_trip(torch.cat([uncond, cond_tar], dim=1), GUIDANCE_SCALE, t_limit)
        return _decode_pair(pipe, rec[:, 0].float(), out[:, 0].float())


class BatchedInstruct:
    """InstructPix2Pix and InstructDiffusion over a batch of images; the
    per-image pipeline is ``editors/instruct_editor.py``'s. The pipeline
    must carry the 8-channel UNet (``configs.IP2P``). The images share one
    noise sequence of one image's shape, drawn from ``seed`` (the JAX class
    gives every image the same key), so each image is its single-image
    edit. As in the editor, the image is encoded in the pipeline's dtype and
    the UNet and the decode compute in f32."""

    VARIANTS = INSTRUCT_VARIANTS

    def __init__(self, pipe: SDPipeline, steps: Optional[int] = None, seed: int = 1234,
                 tp_group=None):
        self.pipe = _shard(pipe, tp_group)
        self.steps = steps if steps is not None else pipe.schedule.num_steps
        self.seed = seed
        self._cache: Dict[Any, Any] = {}

    @torch.inference_mode()
    def edit_batch(self, method: str, images_u8, text_cond: torch.Tensor,
                   cfg_text: Optional[float] = None,
                   cfg_image: Optional[float] = None) -> np.ndarray:
        """images_u8 (N, H, W, 3) uint8; text_cond (N, 1, 77, D), each
        image's instruction. Returns the edits, uint8 (N, H, W, 3)."""
        if method not in self.VARIANTS:
            raise NotImplementedError(f"{method!r} is not an instruction-editing method")
        pipe = self.pipe
        variant, ct, ci = self.VARIANTS[method]
        images = torch.as_tensor(np.ascontiguousarray(images_u8), device=pipe.device)
        image_cond = pipe.vae.encode(images.to(pipe.dtype) / 127.5 - 1.0, scale=False)
        N = images.shape[0]
        uncond = _cached_embed(self, [""])[None].expand(N, -1, -1, -1)
        gen = torch.Generator(device=pipe.device).manual_seed(self.seed)
        latents = instruct_sample(pipe.unet, pipe.schedule, image_cond[:, None],
                                  text_cond.to(pipe.device), uncond, self.steps,
                                  cfg_text if cfg_text is not None else ct,
                                  cfg_image if cfg_image is not None else ci, gen, variant)[:, 0]
        return to_host(latent_to_image(pipe.vae, latents))


class BatchedBLD:
    """Blended Latent Diffusion over a batch of images; the per-image
    pipeline is the editor's (``editors/bld_editor.py``), on an SD2.1
    pipeline (``configs.SD21``) for the reference's model. The images share
    one noise sequence of one image's shape, drawn from ``seed`` (the JAX
    class gives every image the same key), so each image is its
    single-image edit. The N images' 2 rows go through each UNet call
    together."""

    def __init__(self, pipe: SDPipeline, blending_percentage: float = 0.25, seed: int = 42,
                 tp_group=None):
        self.pipe = _shard(pipe, tp_group)
        self.blending_percentage = blending_percentage
        self.seed = seed
        self._cache: Dict[Any, Any] = {}

    @torch.inference_mode()
    def edit_batch(self, images_u8, latent_masks, cond: torch.Tensor,
                   guidance_scale: float = 7.5) -> np.ndarray:
        """images_u8 (N, H, W, 3) uint8; latent_masks (N, h, w, 1) in {0, 1}
        (``editors.bld_editor.latent_mask``); cond (N, 1, 77, D), each image's
        target prompt. Returns the edits, uint8 (N, H, W, 3) (BLD's
        reconstruction panel is zeros)."""
        pipe = self.pipe
        cond = cond.to(pipe.device)
        N = cond.shape[0]
        uncond = _cached_embed(self, [""])[None].expand(N, -1, -1, -1)
        host_sync("mask", pipe.device)
        masks = torch.as_tensor(np.asarray(latent_masks, np.float32), device=pipe.device)
        gen = torch.Generator(device=pipe.device).manual_seed(self.seed)
        lat = bld_sample(pipe.unet, pipe.schedule, _encode_images(pipe, images_u8), masks,
                         torch.cat([uncond, cond], dim=1), guidance_scale, gen,
                         self.blending_percentage)
        return to_host(latent_to_image(pipe.vae, lat[:, 0]))


class BatchedPix2PixZero:
    """pix2pix-zero (``ddim+`` and ``directinversion+``) over a batch of
    images; the per-image pipeline is the editor's
    (``editors/pix2pix_zero_editor.py``: posterior-sampled encode,
    regularised inversion, the two-pass map-guided edit), with its
    ``steps_offset=1`` schedule. The images share one posterior noise draw
    and one table of rolls from ``seed`` (the JAX class gives every image
    the same key), so each image is its single-image edit; the N images' rows
    go through each UNet call, and each backward, together. Captions come
    from the caller (BLIP's ``caption_batch`` or a caption file), encoded."""

    METHODS = P2Z_METHODS

    def __init__(self, pipe: SDPipeline, steps_offset: int = 1, seed: int = 1234,
                 xa_guidance: float = XA_GUIDANCE, tp_group=None):
        self.pipe = _shard(pipe, tp_group)
        self.schedule = make_ddim_schedule(num_steps=pipe.schedule.num_steps,
                                           steps_offset=steps_offset)
        self.seed = seed
        self.xa_guidance = xa_guidance

    @torch.no_grad()
    def edit_batch(self, method: str, images_u8, cond_caption: torch.Tensor,
                   edit_dir: torch.Tensor, guidance_scale: float = 7.5
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """images_u8 (N, H, W, 3) uint8; cond_caption and edit_dir
        (N, 1, 77, D), each image's caption embedding and edit direction
        (``editors.pix2pix_zero_editor.construct_direction``). Returns
        (recon, edit), uint8 (N, H, W, 3) each."""
        if method not in self.METHODS:
            raise NotImplementedError(f"{method!r} is not a pix2pix-zero method")
        pipe = self.pipe
        rec, edit = p2z_latents(pipe, self.schedule, images_u8, cond_caption.to(pipe.device),
                                edit_dir.to(pipe.device), guidance_scale,
                                method == self.METHODS[1], self.seed, self.xa_guidance)
        return _decode_pair(pipe, rec[:, 0], edit[:, 0])


class BatchedStyleDiffusion:
    """stylediffusion+p2p over a batch of images; the per-image pipeline is
    the editor's (``editors/stylediffusion_editor.py``: CLIP image tokens,
    the inversion with its supervision maps, the per-step network training,
    the reconstruction and the tau-controlled edit). Each image trains its
    own networks from the same start and stops its inner loops on its own
    (the images' rows share each UNet call and backward; their losses, batch
    statistics and stopping never mix). Images whose P2P spec differs run in
    different batches: ``group_items_by_spec``."""

    def __init__(self, pipe: SDPipeline, clip_vision=None, clip_vision_cfg=None,
                 num_inner_steps: int = 100, tau_v: float = TAUS[0], tau_c: float = TAUS[1],
                 tau_s: float = TAUS[2], tau_u: float = TAUS[3], tp_group=None):
        self.pipe = _shard(pipe, tp_group)
        self.clip = (clip_vision if clip_vision is not None else
                     make_clip_vision(pipe.device, clip_vision_cfg or CLIP_VIT_B16))
        if tp_group is not None:  # the JAX class places the CLIP tower split too
            shard_columns_(self.clip, tp_group)
        self.num_inner_steps = num_inner_steps
        self.taus = (tau_v, tau_c, tau_s, tau_u)

    @torch.no_grad()
    def edit_batch(self, p2p_spec: P2PSpec, images_u8, cond_src: torch.Tensor,
                   cond2: torch.Tensor, tensors: Dict[str, torch.Tensor],
                   guidance_scale: float = 7.5, mapper0=None) -> Tuple[np.ndarray, np.ndarray]:
        """images_u8 (N, H, W, 3) uint8; cond_src (N, 1, 77, D); cond2
        (N, 2, 77, D) = [source, target]; tensors: each image's P2P tensors
        (``editors.stylediffusion_editor.stylediffusion_p2p``) stacked on a
        leading N axis. Returns (recon, edit), uint8 (N, H, W, 3) each."""
        pipe = self.pipe
        recon, edit = stylediffusion_latents(
            pipe, self.clip, images_u8, cond_src.to(pipe.device), cond2.to(pipe.device),
            guidance_scale, P2PControl(p2p_spec), tensors, self.num_inner_steps, self.taus,
            mapper0)
        return _decode_pair(pipe, recon[:, 0], edit[:, -1])
