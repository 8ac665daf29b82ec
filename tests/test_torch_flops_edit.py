"""A whole ``directinversion+p2p`` edit counted by the port
(``pnpinversion_tpu_torch/utils/mfu.py::edit_flops``) at TINY on CPU
tensors: counted whole, call by call, extended from fewer steps, and against
the JAX package's count (``scripts/_flops.py``) of the programs
``scripts/mfu.py`` counts, traced on parameter shapes (no JAX compile).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_flops import (EDIT_KW, PROMPTS, group_norm_dots, jax_count, self_replace_flops,
                          time_embedding_flops)
from pnpinversion_tpu_torch.utils import flops, mfu


@functools.lru_cache(maxsize=None)
def tiny():
    """A TINY pipeline on the CPU (random weights from a seed)."""
    from pnpinversion_tpu_torch.configs import TINY
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    return SDPipeline.create(TINY, seed=0, num_ddim_steps=3, device="cpu")


@functools.lru_cache(maxsize=None)
def edit_count(steps: int, images: int, count_steps: int) -> mfu.EditFlops:
    """``edit_flops`` on the TINY pipeline, counted once per module."""
    return mfu.edit_flops(tiny(), steps=steps, images=images, count_steps=count_steps)


def _components(pipe, steps: int) -> dict:
    """Each call the ×1 edit makes, counted on its own: the text tower on
    the two prompts and on two "", the VAE encode, one inversion UNet call
    (1 row), one scan call (3 rows, P2P) inside the self-replace window and
    one outside it, the decode of two latents."""
    from pnpinversion_tpu_torch.control.p2p import P2PControl, stack_tensors
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor

    pipe = mfu.at_steps(pipe, steps)
    editor = P2PEditor(pipe)
    size, lat = pipe.config.image_size, pipe.config.latent_size
    gen = torch.Generator().manual_seed(1)
    image = (np.random.RandomState(0).rand(size, size, 3) * 255).astype(np.uint8)
    x1, x3 = (torch.randn(r, lat, lat, 4, generator=gen) for r in (1, 3))
    with torch.inference_mode():
        cond, uncond = editor.embeds(list(PROMPTS))
        spec, tensors = editor.make_control(list(PROMPTS), blend_word=EDIT_KW["blend_word"],
                                            eq_params=EDIT_KW["eq_params"])
        control = P2PControl(dataclasses.replace(spec, uncond_rows=1))
        ctx3 = torch.cat([uncond[1:], cond])

        def scan(step):
            state = control.init_state(2, heads=pipe.config.unet.num_heads)
            return pipe.unet(x3, 500, ctx3, control, stack_tensors([tensors]), state, step)

        parts = {"text": lambda: editor.embeds(list(PROMPTS)),
                 "encode": lambda: editor.encode_image(image),
                 "inversion": lambda: pipe.unet(x1, 500, cond[:1]),
                 "scan_window": lambda: scan(spec.self_replace_start),
                 "scan": lambda: scan(spec.self_replace_end),
                 "decode": lambda: editor.decode_image(torch.cat([x1, x1]))}
        window = spec.self_replace_end - spec.self_replace_start
        return {name: flops.count_flops(fn)[1] for name, fn in parts.items()}, window


@pytest.mark.parametrize("steps", [2, 3])
def test_tiny_edit_direct_count_is_calls_times_their_count(steps):
    """The ×1 edit counted whole (``edit_flops`` at ``count_steps=steps``)
    equals its calls, each counted on its own, times how many the edit
    makes; and a count at 2 steps extends to 3 exactly."""
    direct = edit_count(steps, 1, steps)
    parts, window = _components(tiny(), steps)
    calls = (parts["text"] + parts["encode"] + steps * parts["inversion"]
             + window * parts["scan_window"] + (steps - window) * parts["scan"]
             + parts["decode"])
    assert direct.total == calls
    assert direct.window_steps == window
    assert edit_count(steps, 1, 2).total == direct.total
    assert parts["scan_window"].total - parts["scan"].total == self_replace_flops(
        tiny().config.unet)


@functools.lru_cache(maxsize=None)
def _jax_tiny_shapes():
    """The JAX TINY pipeline's parameter shapes (``jax.eval_shape``)."""
    from pnpinversion_tpu.configs import TINY as JTINY
    from pnpinversion_tpu.models.clip_text import init_clip_text_params
    from pnpinversion_tpu.models.unet import init_unet_params
    from pnpinversion_tpu.models.vae import init_vae_params

    key = jax.random.PRNGKey(0)
    return {"unet": jax.eval_shape(lambda k: init_unet_params(k, JTINY.unet), key),
            "vae": jax.eval_shape(lambda k: init_vae_params(k, JTINY.vae), key),
            "text": jax.eval_shape(lambda k: init_clip_text_params(k, JTINY.text), key)}


def _jax_tiny(steps: int):
    """The JAX TINY pipeline on parameter shapes (the programs are only
    traced), its editor and its ×N sweep."""
    from pnpinversion_tpu.configs import TINY as JTINY
    from pnpinversion_tpu.editors.p2p_editor import P2PEditor
    from pnpinversion_tpu.parallel.sweep import BatchedDirectInversionP2P, make_dp_mesh
    from pnpinversion_tpu.pipeline import SDPipeline
    from pnpinversion_tpu.schedulers.ddim import make_ddim_schedule
    from pnpinversion_tpu.utils.tokenizer import default_tokenizer

    pipe = SDPipeline(config=JTINY, params=_jax_tiny_shapes(), tokenizer=default_tokenizer(),
                      schedule=make_ddim_schedule(steps), dtype=jnp.float32)
    return pipe, P2PEditor(pipe), BatchedDirectInversionP2P(pipe, make_dp_mesh(1))


def _controls(steps: int):
    """The JAX pipeline, editor and sweep at ``steps``, the JAX and the port's
    P2P spec and tensors of the cake edit, and the self-replace products
    the port skips (the steps outside the window)."""
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor

    jpipe, jeditor, jsweep = _jax_tiny(steps)
    jspec, jtensors = jeditor._make_control(
        list(PROMPTS), cross_replace_steps=0.4, self_replace_steps=0.6,
        blend_word=EDIT_KW["blend_word"], eq_params=EDIT_KW["eq_params"],
        is_replace_controller=False)
    editor = P2PEditor(mfu.at_steps(tiny(), steps))
    spec, tensors = editor.make_control(list(PROMPTS), blend_word=EDIT_KW["blend_word"],
                                        eq_params=EDIT_KW["eq_params"])
    window = spec.self_replace_end - spec.self_replace_start
    replace = (steps - window) * self_replace_flops(tiny().config.unet)
    return jpipe, jeditor, jsweep, jspec, jtensors, editor, spec, tensors, window, replace


def _zeros(*shape):
    return np.zeros(shape, np.float32)


@pytest.mark.parametrize("steps", [2, 3])
def test_tiny_fused_scan_matches_jax(steps):
    """``scripts/mfu.py``'s program at batch 1, built as it builds it: the
    fused offsets+edit scan (``P2PEditor._fused_direct``). Its JAX count is
    the port's count of ``P2PEditor.fused_edit`` plus the JAX GroupNorm's
    products and the self-replace products of the steps outside the window,
    and the port's count is its scan calls times how many the edit makes."""
    jpipe, jeditor, _, jspec, jtensors, editor, spec, tensors, window, replace = _controls(steps)
    lat, d = tiny().config.latent_size, tiny().config.text.width
    want = jax_count(jeditor._fused_direct(jspec), jpipe.params["unet"],
                     _zeros(steps + 1, 1, lat, lat, 4), _zeros(2, 77, d), _zeros(2, 77, d),
                     np.float32(7.5), jtensors)
    gen = torch.Generator().manual_seed(2)
    traj = torch.randn(steps + 1, 1, lat, lat, 4, generator=gen)
    cond, uncond = torch.randn(2, 77, d, generator=gen), torch.randn(2, 77, d, generator=gen)
    with torch.inference_mode(), group_norm_dots() as gn, flops.FlopCounter() as fc:
        editor.fused_edit(spec, traj, cond, uncond, 7.5, tensors)
    assert fc.count.total + gn[0] + replace == want
    ef = edit_count(steps, 1, 2)
    assert fc.count == (steps - window) * ef.scan_call + window * ef.scan_window_call


def test_tiny_batched_edit_matches_jax():
    """``scripts/mfu.py``'s program at batch 4, built as it builds it: the
    sweep's whole per-image program (encode, inversion, scan, decode;
    ``BatchedDirectInversionP2P._fn``), at 3 steps (one inside the
    self-replace window, two outside). Its JAX count is the port's count of
    ``BatchedDirectInversionP2P.edit_batch`` plus the JAX GroupNorm's and the
    skipped self-replace products, less the timestep embedding of the three
    images past the first (the inversion's row and the scan's three rows a
    step), which the JAX ``vmap`` computes once; and the port's count at 2
    steps extends to it."""
    steps, n = 3, 4
    jpipe, _, jsweep, jspec, jtensors, _, _, _, _, replace = _controls(steps)
    size, d = tiny().config.image_size, tiny().config.text.width
    jt = {k: np.stack([np.asarray(v)] * n) for k, v in jtensors.items()}
    with jsweep.mesh:
        want = jax_count(jsweep._fn(jspec), jpipe.params, np.zeros((n, size, size, 3), np.uint8),
                         _zeros(n, 2, 77, d), _zeros(n, 2, 77, d), np.float32(7.5), jt)
    with group_norm_dots() as gn:
        direct = mfu.edit_flops(tiny(), steps=steps, images=n, count_steps=steps)
    hoisted = (n - 1) * (1 + 3) * steps * time_embedding_flops(tiny().unet)
    assert direct.total.total + gn[0] + n * replace - hoisted == want
    assert edit_count(steps, n, 2).total == direct.total
