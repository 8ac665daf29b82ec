"""EDICT editor: coupled-latent, exactly invertible editing (port of
``pnpinversion_tpu/editors/edict_editor.py``).

``coupled_scan`` is one EDICT pass: alternating (leapfrog) updates in which
each latent of the pair is stepped with the UNet's eps at the *other* latent,
plus the mixing layers (unmix before the updates when inverting, mix after
them when generating). ``EDICTEditor`` inverts with the source prompt at
strength 0.8 and regenerates with the target prompt (guidance 3); its
reconstruction panel is a full strength-1.0 round trip at guidance 7. The
strip is [instruction | ground truth | reconstruction | edit].

Methods: ``edict+direct_forward`` (the target prompt directly) and
``edict+p2p`` (the source prompt with the attention takeover from the edit
prompt, ``control/edict_p2p.py``).

Precision: EDICT's UNet and VAE compute in f32 (on a bf16 pipeline too: the
layers cast their weights to the f32 activations), as the JAX package runs
them. The latent
pair is carried in f32 (``precision="f32"``) or in float64
(``precision="df64"``, the JAX package's double-float carry made native:
``schedulers/edict_df.py``); the UNet sees the carry's f32 rounding. The
schedule has ``steps_offset`` 0 (EDICT builds a plain DDIMScheduler).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pnpinversion_tpu_torch.control.base import NO_CONTROL, BaseControl
from pnpinversion_tpu_torch.control.edict_p2p import EdictP2PControl, make_edict_p2p_tensors
from pnpinversion_tpu_torch.control.p2p import stack_tensors
from pnpinversion_tpu_torch.editors.base import Editor
from pnpinversion_tpu_torch.models.unet import UNet, apply_images
from pnpinversion_tpu_torch.pipeline import SDPipeline
from pnpinversion_tpu_torch.schedulers.ddim import (
    DDIMSchedule,
    _scalar,
    classifier_free_guidance,
    make_ddim_schedule,
)
from pnpinversion_tpu_torch.schedulers.edict import (
    edict_forward_step,
    edict_mix,
    edict_reverse_step,
    edict_unmix,
)
from pnpinversion_tpu_torch.schedulers.edict_df import (
    edict_df_coeffs,
    edict_mix_f64,
    edict_step_f64,
    edict_unmix_f64,
)

METHODS = ("edict+direct_forward", "edict+p2p")
PRECISIONS = ("f32", "df64")
MIX_WEIGHT = 0.93  # the mixing layers' p
INIT_IMAGE_STRENGTH = 0.8  # the edit inverts and regenerates the last int(T * 0.8) steps
GUIDANCE_SCALE = 3.0  # of the edit
RECON_GUIDANCE_SCALE = 7.0  # of the reconstruction, a strength-1.0 round trip


def _first_index(i: int, length: int, reverse: bool) -> int:
    """Which latent of the pair step i updates first (the reference's
    leapfrog order, which differs between the two directions)."""
    return (length - i) % 2 if reverse else i % 2


def coupled_scan(
    unet: UNet,
    schedule: DDIMSchedule,
    pair: torch.Tensor,  # (N, 2, h, w, c)
    context: torch.Tensor,  # (N, 2, 77, D) [uncond, cond]
    guidance_scale: float,
    t_limit: int,
    reverse: bool,
    control: BaseControl = NO_CONTROL,
    tensors: Optional[Dict[str, torch.Tensor]] = None,
    edit_context: Optional[torch.Tensor] = None,  # (N, 1, 77, D) for the p2p takeover
    precision: str = "f32",
) -> torch.Tensor:
    """One EDICT pass over timesteps[t_limit:] (flipped when ``reverse``) for
    N images; ``unet`` computes in f32 (it is fed the pair's f32 rounding).
    Without ``edit_context`` each update
    runs the UNet on 2 rows per image [uncond, cond]; with it on 3 [uncond,
    base-cond, edit-cond] under ``control`` (the takeover splices the base
    row's attention into the edit row), and the guidance takes the edit row.
    Returns the pair: f32, or float64 for ``precision="df64"`` (its input may
    be the float64 pair of an earlier pass), whose coefficients are those of
    the timesteps the UNet sees."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    df = precision == "df64"
    ts = list(schedule.timesteps[t_limit:])
    if reverse:
        ts = ts[::-1]
    length = len(ts)
    if df:
        a, c = edict_df_coeffs(ts, schedule.step_ratio, reverse,
                               schedule.num_train_timesteps)
        mix, unmix = edict_mix_f64, edict_unmix_f64
    else:
        step_fn = edict_reverse_step if reverse else edict_forward_step
        mix, unmix = edict_mix, edict_unmix
    ctx = context if edit_context is None else torch.cat([context, edit_context], dim=1)
    rows = ctx.shape[1]
    state = control.init_state(rows, heads=unet.config.num_heads, device=pair.device,
                               images=pair.shape[0])
    pair = pair.to(torch.float64 if df else torch.float32)

    def update(pair, idx, i):
        x_in = pair[:, 1 - idx].float()
        x_rows = x_in[:, None].expand((-1, rows) + x_in.shape[1:])
        out, _ = apply_images(unet, x_rows, ts[i], ctx, control, tensors, state, i)
        eps = classifier_free_guidance(out[:, 0], out[:, rows - 1], guidance_scale)
        base = pair[:, idx]
        new = edict_step_f64(base, eps, a[i], c[i]) if df else step_fn(schedule, eps, ts[i],
                                                                       base)
        return torch.stack([new, pair[:, 1]] if idx == 0 else [pair[:, 0], new], dim=1)

    for i in range(length):
        if reverse:
            pair = unmix(pair, MIX_WEIGHT)
        first = _first_index(i, length, reverse)
        pair = update(pair, first, i)
        pair = update(pair, 1 - first, i)
        if not reverse:
            pair = mix(pair, MIX_WEIGHT)
    return pair


class EDICTEditor(Editor):
    """``precision`` is "f32" (the default) or "df64" (a float64 carry)."""

    def __init__(self, pipeline: SDPipeline, precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        super().__init__(pipeline)
        self.precision = precision
        self.schedule = make_ddim_schedule(num_steps=pipeline.schedule.num_steps)

    def __call__(self, edit_method, image_path, prompt_src, prompt_tar) -> np.ndarray:
        if edit_method not in METHODS:
            raise NotImplementedError(f"No edit method named {edit_method}")
        return self.edit(image_path, prompt_src, prompt_tar,
                         use_p2p=edit_method == "edict+p2p")

    @torch.inference_mode()
    def edit(self, image_path, prompt_src, prompt_tar, use_p2p=False) -> np.ndarray:
        pipe, sched = self.pipe, self.schedule
        T = sched.num_steps
        image_gt = self.load(image_path)
        latent = self.encode_image(image_gt, dtype=torch.float32)
        pair0 = torch.stack([latent, latent], dim=1)
        uncond, cond_src, cond_tar = (pipe.encode_prompt([p]) for p in ("", prompt_src,
                                                                          prompt_tar))
        ctx_src = torch.cat([uncond, cond_src])[None]
        ctx_tar = torch.cat([uncond, cond_tar])[None]
        # the guidance scales as the JAX editor makes them, in the pipeline's dtype
        g7, g3 = (_scalar(g, uncond) for g in (RECON_GUIDANCE_SCALE, GUIDANCE_SCALE))

        def scan(pair, ctx, g, t_limit, reverse, **kw):
            return coupled_scan(pipe.unet, sched, pair, ctx, g, t_limit, reverse,
                                precision=self.precision, **kw)

        # the reconstruction: a full round trip at strength 1.0, guidance 7
        rec = scan(scan(pair0, ctx_src, g7, 0, True), ctx_src, g7, 0, False)
        # the edit: strength 0.8, guidance 3
        t_limit = T - int(T * INIT_IMAGE_STRENGTH)
        inv = scan(pair0, ctx_src, g3, t_limit, True)
        if use_p2p:
            tensors = make_edict_p2p_tensors(prompt_src, prompt_tar, pipe.tokenizer,
                                             pipe.config.text.max_length, device=pipe.device)
            out = scan(inv, ctx_src, g3, t_limit, False, control=EdictP2PControl(T),
                       tensors=stack_tensors([tensors]), edit_context=cond_tar[None])
        else:
            out = scan(inv, ctx_tar, g3, t_limit, False)
        recon, edit = self.decode_image(torch.cat([rec[:, 0], out[:, 0]]).float())
        return self.strip(prompt_src, prompt_tar, image_gt, recon, edit)
