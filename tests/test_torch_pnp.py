"""Plug-and-Play in the PyTorch port vs the JAX package: the control's q/k and
residual hooks at N = 1 and N = 2 images (the JAX side under ``jax.vmap``),
the steps_offset=1 loops (inversion, the re-denoising trajectory, the
injection loop; timesteps 981..1 at 50 steps, 667..1 here), both editors'
strips at TINY with 3 DDIM steps (f32 on the CPU), and ``BatchedPnP``
against the port's single-image editor."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    assert_panels_close,
    assert_strips_match,
    jax_torch_pipelines,
    rel_err,
    seeded_images,
)
from pnpinversion_tpu.configs import SD14 as JSD14
from pnpinversion_tpu.configs import TINY as JTINY
from pnpinversion_tpu.control import pnp as jpnp
from pnpinversion_tpu.control.base import AttnSite as JaxSite
from pnpinversion_tpu.editors.pnp_editor import PnPEditor as JaxPnPEditor
from pnpinversion_tpu_torch.configs import SD14, TINY
from pnpinversion_tpu_torch.control import pnp as tpnp
from pnpinversion_tpu_torch.control.base import AttnSite
from pnpinversion_tpu_torch.editors.pnp_editor import (
    METHODS,
    PnPEditor,
    ddim_sample_trajectory,
    pnp_embeds,
    pnp_sample_loop,
)
from pnpinversion_tpu_torch.inversion.ddim_inversion import ddim_invert_loop
from pnpinversion_tpu_torch.parallel.sweep import BatchedPnP

torch.set_num_threads(2)

STEPS = 3
G = 7.5
# f32 on both sides, relative to max |reference|, as test_torch_sampling.py
RTOL = 1e-4
PROMPTS = [("a cat on a mat", "a dog on a mat"), ("a red car", "a blue car")]


def test_injection_sites_match_jax():
    for jcfg, tcfg in ((JTINY.unet, TINY.unet), (JSD14.unet, SD14.unet)):
        assert tpnp.pnp_injection_sites(tcfg) == jpnp.pnp_injection_sites(jcfg)
    assert tpnp.pnp_injection_sites(SD14.unet) == tuple(range(8, 16))
    spec = tpnp.make_pnp_control(SD14.unet, 50).spec
    assert (spec.qk_t, spec.conv_t, tpnp.ROWS) == (25, 40, 3)


def _rows(seed, n, shape):
    return np.random.RandomState(seed).randn(n, 3, *shape).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("step", [0, 1])
def test_qkv_hook_matches_jax_vmap(n, step):
    """q and k of every row replaced by their image's source row's while the
    step is below qk_t (1 here), v kept: bit for bit."""
    q, k, v = (_rows(s, n, (2, 16, 8)) for s in (1, 2, 3))
    jctrl = jpnp.make_pnp_control(JTINY.unet, STEPS)
    tctrl = tpnp.make_pnp_control(TINY.unet, STEPS)
    site = dict(index=tctrl.spec.sites[0], place="up", resolution=4, is_cross=False, heads=2)
    want = jax.vmap(lambda a, b, c: jctrl.qkv_hook(JaxSite(**site), a, b, c, {}, {},
                                                   jnp.int32(step)))(q, k, v)
    got = tctrl.qkv_hook(AttnSite(**site), *(torch.from_numpy(x.reshape(3 * n, 2, 16, 8))
                                             for x in (q, k, v)), {}, {}, step)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().reshape(w.shape), np.asarray(w))
    if step == 0 and n == 2:
        qq = got[0].numpy().reshape(q.shape)
        np.testing.assert_array_equal(qq[1, 2], q[1, 0])
        assert not np.array_equal(qq[0], qq[1])
    other = AttnSite(**dict(site, index=3))
    assert tctrl.qkv_hook(other, *got, {}, {}, 0) == got


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("step", [1, 2])
def test_resnet_hook_matches_jax_vmap(n, step):
    """The residual branch of up_1_resnet_1 replaced by the image's source
    row's while the step is below conv_t (2 here); the port's activations are
    NCHW in the channels-last format, and stay so."""
    hidden = _rows(4, n, (4, 4, 8))  # NHWC, as the JAX package's
    jctrl = jpnp.make_pnp_control(JTINY.unet, STEPS)
    tctrl = tpnp.make_pnp_control(TINY.unet, STEPS)
    want = jax.vmap(lambda h: jctrl.resnet_hook("up_1_resnet_1", h, {}, {},
                                                jnp.int32(step)))(hidden)
    x = torch.from_numpy(hidden.reshape(3 * n, 4, 4, 8)).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    got = tctrl.resnet_hook("up_1_resnet_1", x, {}, {}, step)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy().reshape(want.shape),
                                  np.asarray(want))
    assert tctrl.resnet_hook("up_1_resnet_0", x, {}, {}, 0) is x


@pytest.fixture(scope="module")
def setup():
    jpipe, tpipe = jax_torch_pipelines(seed=91, steps=STEPS)
    jed, ted = JaxPnPEditor(jpipe), PnPEditor(tpipe)
    assert ted.schedule.timesteps == tuple(int(t) for t in jed.schedule.timesteps) == (667, 334, 1)
    rng = np.random.RandomState(92)
    arrays = dict(latent=rng.randn(2, 1, 8, 8, 4).astype(np.float32),
                  emb=rng.randn(2, 3, 77, 32).astype(np.float32))
    return jed, ted, arrays


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def test_invert_and_trajectory_steps_offset(setup):
    """DDIM inversion and the re-denoising trajectory on the steps_offset=1
    schedule, whose last step runs at t = 1 (alpha_prev: the final alpha)."""
    jed, ted, arr = setup
    _, _, inv, smp = jed._phases()
    p = jed.pipe.params["unet"]
    lat, emb = arr["latent"], arr["emb"][:, :1]
    with torch.inference_mode():
        traj = ddim_invert_loop(ted.pipe.unet, ted.schedule, _t(lat), _t(emb))
        recon = ddim_sample_trajectory(ted.pipe.unet, ted.schedule, traj[:, -1], _t(emb))
    for i in range(2):
        want = inv(p, jnp.asarray(lat[i]), jnp.asarray(emb[i]))
        assert rel_err(traj[i], want) <= RTOL
        assert rel_err(recon[i], smp(p, want[-1], jnp.asarray(emb[i]))) <= RTOL


def test_pnp_sample_loop_matches_jax(setup):
    """The 3-row injection loop on two images at once, each against the JAX
    loop alone; the injection acts (a spec with no injection steps moves the
    result)."""
    jed, ted, arr = setup
    src = np.random.RandomState(93).randn(2, STEPS, 1, 8, 8, 4).astype(np.float32)
    x0, emb = arr["latent"], arr["emb"]
    control = tpnp.make_pnp_control(TINY.unet, STEPS)
    with torch.inference_mode():
        got = pnp_sample_loop(ted.pipe.unet, ted.schedule, control, _t(src), _t(x0), _t(emb), G)
        off = pnp_sample_loop(ted.pipe.unet, ted.schedule, tpnp.PnPControl(
            dataclasses.replace(control.spec, qk_t=0, conv_t=0)), _t(src), _t(x0), _t(emb), G)
    fn = jed._pnp_forward(jpnp.make_pnp_control(JTINY.unet, STEPS).spec)
    for i in range(2):
        want = fn(jed.pipe.params["unet"], jnp.asarray(src[i]), jnp.asarray(x0[i]),
                  jnp.asarray(emb[i]), jnp.asarray(G, jnp.float32))
        assert rel_err(got[i], want) <= RTOL
    assert rel_err(off, got) > 1e-2


def test_embeds_match_jax(setup):
    jed, ted, _ = setup
    got = pnp_embeds(ted.pipe, [PROMPTS[0][1]])[0]
    assert rel_err(got, jed._embeds(PROMPTS[0][1])) <= 1e-5


@pytest.mark.parametrize("method", METHODS)
def test_editor_strip(setup, method):
    jed, ted, _ = setup
    img = seeded_images(94, 1)[0]
    src, tar = PROMPTS[0]
    assert_strips_match(ted(method, img, src, tar, G), np.asarray(jed(method, img, src, tar, G)))


@pytest.mark.parametrize("method", METHODS)
def test_batched_matches_single_editor(setup, method):
    """Two images with their own prompts through one batched edit == each
    through the single-image editor."""
    _, ted, _ = setup
    pipe, size = ted.pipe, ted.pipe.config.image_size
    imgs = seeded_images(95, 2)
    cond_src = torch.stack([pipe.encode_prompt([src]) for src, _ in PROMPTS])
    cond_tar = torch.stack([pipe.encode_prompt([tar]) for _, tar in PROMPTS])
    recon, edit = BatchedPnP(pipe).edit_batch(method, imgs, cond_src, cond_tar, G)
    for i, (src, tar) in enumerate(PROMPTS):
        want = ted(method, imgs[i], src, tar, G)[:, 2 * size:]
        assert_panels_close(np.concatenate([recon[i], edit[i]], axis=1), want)
