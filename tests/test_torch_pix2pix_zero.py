"""pix2pix-zero in the PyTorch port vs the JAX package, at TINY with 3 DDIM
steps on the steps_offset=1 schedule, f32 on the CPU: the regularisation
losses and their gradients, ``regularize_noise``, the inverse step, the
inversion, the two-pass edit with and without offsets, the cross-attention
store, the edit direction, the VAE posterior sample, the editor's strips and
``BatchedPix2PixZero`` against the port's single-image editor.

The JAX package draws the posterior noise and the autocorrelation rolls from
``jax.random``, the port from ``torch.Generator``s: here the port gets the
very values JAX draws (its keys split as the JAX functions split them), so
the JAX side runs as it is. The JAX programs of the function tests are the
JAX editor's own (its jit cache), compiled once by the strip tests' fixture."""
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
from pnpinversion_tpu.control.attn_store import CrossAttnStoreControl as JaxStore
from pnpinversion_tpu.editors import pix2pix_zero_editor as jed_mod
from pnpinversion_tpu.inversion import pix2pix_zero as jp2z
from pnpinversion_tpu.models.unet import unet_apply
from pnpinversion_tpu.models.vae import vae_encode, vae_encode_moments
from pnpinversion_tpu_torch.control.attn_store import CrossAttnStoreControl
from pnpinversion_tpu_torch.editors import pix2pix_zero_editor as ted_mod
from pnpinversion_tpu_torch.inversion import pix2pix_zero as tp2z
from pnpinversion_tpu_torch.parallel.sweep import BatchedPix2PixZero
from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule

torch.set_num_threads(2)

STEPS = 3
SEED = 1234  # the editor's default
CAPTION = "a cat sitting on a mat"
PROMPTS = ("a cat on a mat", "a dog on a mat")
VOCAB = "a cat sitting on mat dog in box small"
# relative to max |JAX|, f32 on both sides: forward-only functions, and
# anything with a gradient step (null-text's GRAD_RTOL / LOOP_RTOL)
RTOL = 1e-5
GRAD_RTOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def jax_reg_shifts(key, size: int, rounds: int = 5, rolls: int = 5) -> np.ndarray:
    """The rolls ``regularize_noise`` draws from ``key``, (rounds, rolls,
    levels): its splits and its vmapped randint, run eagerly."""
    highs = jnp.array(tp2z.roll_highs(size))
    out = []
    for kr in jax.random.split(key, rounds):
        out.append([np.asarray(jax.vmap(lambda kk, m: jax.random.randint(kk, (), 0, m))(
            jax.random.split(k, len(highs)), highs)) for k in jax.random.split(kr, rolls)])
    return np.array(out)


def jax_invert_shifts(k_inv, size: int, steps: int) -> np.ndarray:
    """The rolls of ``p2z_invert`` from ``k_inv``: (steps, 5, 5, levels)."""
    key, out = k_inv, []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(jax_reg_shifts(sub, size))
    return np.stack(out)


def jax_editor_draws(seed: int, steps: int, shape=(1, 8, 8, 4)):
    """(posterior noise, rolls) the JAX editor draws from PRNGKey(seed)."""
    k_enc, k_inv = jax.random.split(jax.random.PRNGKey(seed))
    return (np.array(jax.random.normal(k_enc, shape, jnp.float32)),
            jax_invert_shifts(k_inv, shape[1], steps))


@pytest.fixture
def shared_draws(monkeypatch):
    """The port editor's posterior noise and rolls replaced by JAX's for
    ``SEED``."""
    noise, shifts = jax_editor_draws(SEED, STEPS)
    monkeypatch.setattr(ted_mod, "draw_noise", lambda gen, shape, dtype: _t(noise).to(dtype))
    monkeypatch.setattr(ted_mod, "draw_shifts", lambda gen, size, steps: shifts)


@pytest.fixture(scope="module")
def setup():
    """Both pipelines, both editors, and the JAX editor's strips of both
    methods (compiling its programs once for the function tests)."""
    jpipe, tpipe = jax_torch_pipelines(seed=401, steps=STEPS)
    # the word tokenizers number words as first seen: both see every word of
    # this file first, in one order
    for p in (jpipe, tpipe):
        p.encode_prompt([VOCAB])
    jed, ted = jed_mod.Pix2PixZeroEditor(jpipe), ted_mod.Pix2PixZeroEditor(tpipe)
    assert ted.schedule.timesteps == tuple(int(t) for t in jed.schedule.timesteps) == (
        667, 334, 1)
    img = seeded_images(402, 1)[0]
    strips = {m: np.asarray(jed(m, img, *PROMPTS, caption=CAPTION)) for m in ted_mod.METHODS}
    return jpipe, tpipe, jed, ted, img, strips


def test_auto_corr_loss_and_grad_match_jax():
    """The pyramid loss at 64^2 (4 levels, rolls on both axes, 2x2 average
    pooling) and its gradient, per image at N = 2."""
    rng = np.random.RandomState(403)
    x = rng.randn(2, 64, 64, 4).astype(np.float32)
    shifts = [5, 11, 3, 2]
    assert tp2z.roll_highs(64) == [32, 16, 8, 4] and tp2z.roll_highs(8) == [4]
    got = tp2z.auto_corr_loss(_t(x), shifts)
    g = tp2z._grad(lambda z: tp2z.auto_corr_loss(z, shifts), _t(x))
    fn = jax.jit(jax.value_and_grad(lambda z: jp2z.auto_corr_loss(z, jnp.asarray(shifts))))
    for i in range(2):
        loss, grad = fn(jnp.asarray(x[i : i + 1]))
        np.testing.assert_allclose(got[i].item(), float(loss), rtol=RTOL)
        assert rel_err(g[i : i + 1], grad) <= RTOL


def test_kl_divergence_and_grad_match_jax():
    rng = np.random.RandomState(404)
    x = (rng.randn(2, 8, 8, 4) * [[[[0.5]]], [[[1.7]]]] + 0.3).astype(np.float32)
    got = tp2z.kl_divergence(_t(x))
    g = tp2z._grad(tp2z.kl_divergence, _t(x))
    fn = jax.jit(jax.value_and_grad(jp2z.kl_divergence))
    for i in range(2):
        loss, grad = fn(jnp.asarray(x[i : i + 1]))
        np.testing.assert_allclose(got[i].item(), float(loss), rtol=RTOL)
        assert rel_err(g[i : i + 1], grad) <= RTOL


def test_regularize_noise_matches_jax():
    """25 autocorrelation and 5 KL gradient steps at 16^2 (2 levels) on the
    rolls JAX draws from the same key."""
    rng = np.random.RandomState(405)
    eps = rng.randn(1, 16, 16, 4).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jax.jit(jp2z.regularize_noise)(jnp.asarray(eps), key)
    shifts = jax_reg_shifts(key, 16)
    assert shifts.shape == (5, 5, 2)
    got = tp2z.regularize_noise(_t(eps), shifts)
    assert rel_err(got, want) <= GRAD_RTOL
    assert rel_err(got, eps) > 1e-3  # the regularisation moved eps


def test_draw_shifts_ranges():
    """The port's own draw: a (steps, 5, 5, levels) table of ints, each
    level's in [0, its high), the same for the same seed."""
    a = tp2z.draw_shifts(torch.Generator().manual_seed(3), 64, 4)
    b = tp2z.draw_shifts(torch.Generator().manual_seed(3), 64, 4)
    assert a.shape == (4, 5, 5, 4) and np.array_equal(a, b)
    assert all(0 <= a[..., lv].min() and a[..., lv].max() < m
               for lv, m in enumerate(tp2z.roll_highs(64)))


def test_inverse_step_matches_jax():
    """pix2pix-zero's inverse step at every timestep of the 50-step
    steps_offset=1 schedule (the last past t = 1000), in f32 from f32 and
    bf16 inputs."""
    from pnpinversion_tpu.schedulers.ddim import make_ddim_schedule as jmake

    js, ts = jmake(50, steps_offset=1), make_ddim_schedule(50, steps_offset=1)
    rng = np.random.RandomState(406)
    eps, x = rng.randn(1, 8, 8, 4).astype(np.float32), rng.randn(1, 8, 8, 4).astype(np.float32)
    for t in ts.timesteps:
        want = jp2z.p2z_inverse_step(js, jnp.asarray(eps), jnp.int32(t), jnp.asarray(x))
        got = tp2z.p2z_inverse_step(ts, _t(eps), t, _t(x))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)
    bf = tp2z.p2z_inverse_step(ts, _t(eps).bfloat16(), 981, _t(x).bfloat16())
    assert bf.dtype == torch.float32


def test_store_control_matches_jax(setup):
    """One UNet call under the cross-attention store: the same keys (one per
    cross site) and maps within 1e-5 of max, eps unchanged by the store."""
    jpipe, tpipe, *_ = setup
    rng = np.random.RandomState(407)
    x, ctx = rng.randn(2, 8, 8, 4).astype(np.float32), rng.randn(2, 77, 32).astype(np.float32)
    _, want = jax.jit(lambda p, x, c: unet_apply(p, x, jnp.int32(334), c, jpipe.config.unet,
                                                 JaxStore(), {}, {}, step=0))(
        jpipe.params["unet"], jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        eps, got = tpipe.unet(_t(x), 334, _t(ctx), CrossAttnStoreControl(), {}, {}, 0)
        plain, _ = tpipe.unet(_t(x), 334, _t(ctx))
    assert sorted(got) == sorted(want) and len(got) == 7
    for k in want:
        assert rel_err(got[k], want[k]) <= RTOL, k
    torch.testing.assert_close(eps, plain, rtol=0, atol=0)


def test_posterior_sample_matches_jax(setup):
    """The VAE's moments (logvar clipped) and the scaled posterior sample on
    JAX's noise for the key."""
    jpipe, tpipe, *_ = setup
    img = seeded_images(408, 2).astype(np.float32) / 127.5 - 1.0
    key = jax.random.PRNGKey(9)
    mean, logvar, want = jax.jit(lambda p, x: vae_encode_moments(p, x, jpipe.config.vae) + (
        vae_encode(p, x, jpipe.config.vae, rng=key),))(jpipe.params["vae"], jnp.asarray(img))
    noise = jax.random.normal(key, mean.shape, mean.dtype)
    with torch.no_grad():
        tm, tl = tpipe.vae.encode_moments(_t(img))
        assert rel_err(tm, mean) <= RTOL and rel_err(tl, logvar) <= RTOL
        got = tpipe.vae.encode(_t(img), noise=_t(noise))
        assert rel_err(got, want) <= RTOL
        assert rel_err(tpipe.vae.encode(_t(img)), mean * jpipe.config.vae.scaling_factor) <= RTOL


def test_construct_direction_matches_jax(setup):
    jpipe, tpipe, *_ = setup
    src, tgt = ["a cat on a mat", "a cat in a box"], ["a dog on a mat"]
    want = jed_mod.construct_direction(jpipe, src, tgt)
    got = ted_mod.construct_direction(tpipe, src, tgt)
    assert got.shape == (1, 77, 32) and rel_err(got, want) <= RTOL


def test_invert_matches_jax(setup):
    """``p2z_invert`` (the JAX editor's jitted inversion) on JAX's rolls for
    the key: the whole trajectory."""
    jpipe, tpipe, jed, *_ = setup
    rng = np.random.RandomState(409)
    lat, emb = rng.randn(1, 8, 8, 4).astype(np.float32), rng.randn(1, 77, 32).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jed._jit_cache["inv"](jpipe.params["unet"], jnp.asarray(lat), jnp.asarray(emb), key)
    with torch.no_grad():
        got = tp2z.p2z_invert(tpipe.unet, ted_mod.Pix2PixZeroEditor(tpipe).schedule,
                              _t(lat)[None], _t(emb)[None], jax_invert_shifts(key, 8, STEPS))
    assert got.shape == (1, STEPS + 1, 1, 8, 8, 4)
    assert rel_err(got[0], want) <= GRAD_RTOL


@pytest.mark.parametrize("use_offsets", [False, True], ids=["ddim", "offsets"])
def test_edit_matches_jax(setup, use_offsets):
    """``p2z_edit`` (the JAX editor's jitted edit) on random inputs, with
    DirectInversion's offsets and without: recon and edit latents."""
    jpipe, tpipe, jed, ted, *_ = setup
    rng = np.random.RandomState(410 + use_offsets)
    x = rng.randn(1, 8, 8, 4).astype(np.float32)
    pe, ed = rng.randn(2, 77, 32).astype(np.float32), rng.randn(1, 77, 32).astype(np.float32) * .3
    traj = rng.randn(STEPS + 1, 1, 8, 8, 4).astype(np.float32)
    want = jed._jit_cache[("edit", use_offsets)](
        jpipe.params["unet"], jnp.asarray(x), jnp.asarray(pe), jnp.asarray(ed),
        jnp.asarray(7.5, jnp.float32), jnp.asarray(traj))
    with torch.no_grad():
        got = tp2z.p2z_edit(tpipe.unet, ted.schedule, _t(x)[None], _t(pe)[None], _t(ed)[None],
                            7.5, ted_mod.XA_GUIDANCE, _t(traj)[None] if use_offsets else None)
    for g, w in zip(got, want):
        assert g.shape == (1, 1, 8, 8, 4)
        assert rel_err(g[0], w) <= GRAD_RTOL


@pytest.mark.parametrize("method", ted_mod.METHODS)
def test_editor_strip_matches_jax(setup, shared_draws, method):
    """Both editors with an injected caption on JAX's noise and rolls:
    [instruction | image | reconstruction | edit]."""
    _, _, _, ted, img, strips = setup
    assert_strips_match(ted(method, img, *PROMPTS, caption=CAPTION), strips[method])


def test_editor_needs_a_caption(setup):
    _, _, _, ted, img, _ = setup
    with pytest.raises(ValueError):
        ted("ddim+pix2pix-zero", img, *PROMPTS)
    with pytest.raises(NotImplementedError):
        ted("pix2pix-zero", img, *PROMPTS, caption=CAPTION)
    seen = []
    captioned = ted_mod.Pix2PixZeroEditor(ted.pipe, captioner=lambda im: seen.append(im) or "a")
    captioned("ddim+pix2pix-zero", img, *PROMPTS)
    assert len(seen) == 1 and np.array_equal(seen[0], img)


@pytest.mark.parametrize("method", ted_mod.METHODS)
def test_batched_matches_single_editor(setup, method):
    """``BatchedPix2PixZero`` on 2 images, each with its own caption and
    direction (the generators' own draws, shared by the images), against the
    port's single-image editor within 2 uint8 levels."""
    _, tpipe, _, ted, _, _ = setup
    imgs = seeded_images(412, 2)
    captions = [CAPTION, "a small dog"]
    pairs = [PROMPTS, ("a small dog", "a small cat")]
    cond = torch.stack([tpipe.encode_prompt([c]) for c in captions])
    dirs = torch.stack([ted_mod.construct_direction(tpipe, [s], [t]) for s, t in pairs])
    recon, edit = BatchedPix2PixZero(tpipe).edit_batch(method, imgs, cond, dirs)
    for i in range(2):
        strip = ted(method, imgs[i], *pairs[i], caption=captions[i])
        assert_panels_close(recon[i], strip[:, 32:48])
        assert_panels_close(edit[i], strip[:, 48:])
