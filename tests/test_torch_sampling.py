"""DDIM schedule and steps, DDIM inversion, the P2P control tensors, the
source-free fused scan and the directinversion+p2p editor of the PyTorch
port vs the JAX package, at TINY with 4 DDIM steps, f32 on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import jax_pipeline, pipeline_params, rel_err, torch_pipeline
from pnpinversion_tpu.configs import TINY as JTINY
from pnpinversion_tpu.control.p2p import P2PControl as JaxP2PControl
from pnpinversion_tpu.control.p2p import make_p2p_control as jax_make_p2p_control
from pnpinversion_tpu.editors.p2p_editor import P2PEditor as JaxP2PEditor
from pnpinversion_tpu.inversion.ddim_inversion import ddim_invert_loop as jax_invert
from pnpinversion_tpu.sampling.p2p_forward import (
    fused_direct_inversion_edit_srcfree as jax_fused,
)
from pnpinversion_tpu.schedulers import ddim as jddim
from pnpinversion_tpu.utils.tokenizer import SimpleWordTokenizer as JaxTokenizer
from pnpinversion_tpu_torch.control.p2p import P2PControl, make_p2p_control
from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor
from pnpinversion_tpu_torch.inversion.ddim_inversion import ddim_invert_loop
from pnpinversion_tpu_torch.sampling.p2p_forward import fused_direct_inversion_edit_srcfree
from pnpinversion_tpu_torch.schedulers import ddim as tddim
from pnpinversion_tpu_torch.utils.tokenizer import default_tokenizer

STEPS = 4
# f32 on both sides; summation-order noise compounds over the UNet's depth
# and the 4-step loops. Relative to max |reference|.
RTOL = 1e-4
SRC, TAR = "a cat on a mat", "a silver cat on a mat"
P2P_KW = dict(blend_word=(("cat",), ("cat",)), eq_params={"words": ("silver",), "values": (2.0,)})


@pytest.fixture(scope="module")
def pipes():
    params = pipeline_params(JTINY, seed=7)
    return jax_pipeline(params, STEPS), torch_pipeline(params, STEPS)


def _control_pair(jpipe, tpipe):
    kw = dict(num_steps=STEPS, blend_words=P2P_KW["blend_word"], eq_params=P2P_KW["eq_params"],
              num_lb_slots=tpipe.num_lb_slots, lb_res=tpipe.lb_res,
              latent_size=tpipe.latent_size)
    return (jax_make_p2p_control([SRC, TAR], JaxTokenizer(), **kw),
            make_p2p_control([SRC, TAR], default_tokenizer(), **kw))


@pytest.mark.parametrize("steps", [4, 50])
def test_ddim_schedule(steps):
    want, got = jddim.make_ddim_schedule(steps), tddim.make_ddim_schedule(steps)
    np.testing.assert_array_equal(got.alphas_cumprod, np.asarray(want.alphas_cumprod))
    assert got.final_alpha_cumprod == np.asarray(want.final_alpha_cumprod)
    assert list(got.timesteps) == np.asarray(want.timesteps).tolist()


@pytest.mark.parametrize("t", [981, 481, 0])
def test_ddim_steps(t):
    """Forward and inverse steps, including the t - step_ratio < 0 boundary
    (final alpha), and classifier-free guidance."""
    rng = np.random.RandomState(t)
    x, eps, eps2 = (rng.randn(2, 8, 8, 4).astype(np.float32) for _ in range(3))
    js, ts = jddim.make_ddim_schedule(50), tddim.make_ddim_schedule(50)
    X, E, E2 = (torch.from_numpy(a) for a in (x, eps, eps2))
    for jfn, tfn in ((jddim.ddim_step, tddim.ddim_step),
                     (jddim.ddim_inverse_step, tddim.ddim_inverse_step)):
        want = jfn(js, jnp.asarray(eps), jnp.asarray(t), jnp.asarray(x))
        np.testing.assert_allclose(tfn(ts, E, t, X).numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    want = jddim.classifier_free_guidance(jnp.asarray(eps), jnp.asarray(eps2), 7.5)
    np.testing.assert_allclose(tddim.classifier_free_guidance(E, E2, 7.5).numpy(),
                               np.asarray(want), atol=1e-5)


def test_ddim_step_rounds_alphas_to_bf16():
    """Alpha scalars are rounded to the sample's dtype before they multiply
    it, as the JAX package's _broadcast does."""
    x = torch.full((1, 2), 3.0, dtype=torch.bfloat16)
    s = tddim.make_ddim_schedule(50)
    a = float(np.sqrt(np.float32(s.alpha_at(981))))
    rounded = torch.tensor(a, dtype=torch.bfloat16).item()
    assert rounded != a
    got = tddim.pred_x0_from_eps(x, torch.zeros_like(x), s.alpha_at(981))
    assert got[0, 0].item() == (x / torch.tensor(rounded, dtype=torch.bfloat16))[0, 0].item()


def test_make_p2p_control_equal(pipes):
    jpipe, tpipe = pipes
    (jctrl, jt), (tctrl, tt) = _control_pair(jpipe, tpipe)
    jspec = dataclasses.asdict(jctrl.spec)
    assert dataclasses.asdict(tctrl.spec) == {k: jspec[k] for k in dataclasses.asdict(tctrl.spec)}
    assert sorted(tt) == sorted(jt)
    for k in jt:
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]))


@pytest.mark.parametrize("size", [4, 16])
def test_localblend_nearest_resize(size):
    """jax.image.resize(..., 'nearest') up by an integer factor ==
    F.interpolate(mode='nearest')."""
    m = np.random.RandomState(size).rand(2, size, size).astype(np.float32)
    want = jax.image.resize(jnp.asarray(m), (2, size * 4, size * 4), method="nearest")
    got = F.interpolate(torch.from_numpy(m)[:, None], size=(size * 4, size * 4),
                        mode="nearest")[:, 0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ddim_invert_loop(pipes):
    jpipe, tpipe = pipes
    rng = np.random.RandomState(11)
    latent = rng.randn(1, 8, 8, 4).astype(np.float32)
    emb = rng.randn(1, 77, 32).astype(np.float32)
    want = jax.jit(lambda p, l, e: jax_invert(p, jpipe.schedule, l, e, jpipe.config.unet))(
        jpipe.params["unet"], jnp.asarray(latent), jnp.asarray(emb))
    with torch.inference_mode():
        got = ddim_invert_loop(tpipe.unet, tpipe.schedule, torch.from_numpy(latent),
                               torch.from_numpy(emb))
    assert got.shape == (STEPS + 1, 1, 8, 8, 4)
    np.testing.assert_array_equal(got[0].numpy(), latent)
    assert rel_err(got, want) <= RTOL


def test_fused_srcfree_scan(pipes):
    jpipe, tpipe = pipes
    rng = np.random.RandomState(12)
    traj = rng.randn(STEPS + 1, 1, 8, 8, 4).astype(np.float32)
    cond = rng.randn(2, 77, 32).astype(np.float32)
    uncond = rng.randn(2, 77, 32).astype(np.float32)
    (jctrl, jt), (tctrl, tt) = _control_pair(jpipe, tpipe)
    jc = JaxP2PControl(dataclasses.replace(jctrl.spec, uncond_rows=1))
    tc = P2PControl(dataclasses.replace(tctrl.spec, uncond_rows=1))
    want = jax.jit(lambda p, tr, c, u, tensors: jax_fused(
        p, jpipe.schedule, jpipe.config.unet, tr, c, u, jnp.asarray(7.5), jc, tensors))(
        jpipe.params["unet"], jnp.asarray(traj), jnp.asarray(cond), jnp.asarray(uncond), jt)
    with torch.inference_mode():
        got = fused_direct_inversion_edit_srcfree(
            tpipe.unet, tpipe.schedule, torch.from_numpy(traj), torch.from_numpy(cond),
            torch.from_numpy(uncond), 7.5, tc, tt)
    assert got.shape == (2, 8, 8, 4)
    # the source row re-snaps to the inversion trajectory
    np.testing.assert_array_equal(got[0].numpy(), traj[0, 0])
    assert rel_err(got, want) <= RTOL


def test_editor_strip(pipes):
    """directinversion+p2p end to end: the same image and prompts through
    both packages' P2PEditor."""
    jpipe, tpipe = pipes
    jpipe.tokenizer, tpipe.tokenizer = JaxTokenizer(), default_tokenizer()
    img = (np.random.RandomState(13).rand(16, 16, 3) * 255).astype(np.uint8)
    want = np.asarray(JaxP2PEditor(jpipe)("directinversion+p2p", img, SRC, TAR, **P2P_KW))
    got = P2PEditor(tpipe)("directinversion+p2p", img, SRC, TAR, **P2P_KW)
    assert got.shape == want.shape == (16, 64, 3) and got.dtype == np.uint8
    # the instruction and ground-truth panels are exact; the decoded panels
    # are truncated to uint8, which flips a value wherever the f32 noise of
    # 8 UNet calls and a decode straddles an integer
    np.testing.assert_array_equal(got[:, :32], want[:, :32])
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_editor_rejects_unported_methods(pipes):
    with pytest.raises(NotImplementedError, match="A7"):
        P2PEditor(pipes[1])("null-text-inversion+p2p", np.zeros((16, 16, 3), np.uint8),
                            SRC, TAR)
