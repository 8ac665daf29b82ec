"""Blended Latent Diffusion in the PyTorch port vs the JAX package, at TINY
with 4 DDIM steps (3 blended steps at blending_percentage 0.25), f32 on the
CPU: the SD2.1 constants and a head_dim UNet with a GELU text tower,
``add_noise``, the latent mask's PIL nearest resize, ``bld_sample``, the
editor's strip and ``BatchedBLD`` against the port's single-image editor.

The JAX package draws its noise from ``jax.random``, the port from a
``torch.Generator``: here the port's draws are replaced by the very values
JAX draws (its keys split as ``bld_sample`` splits them), so the JAX side
runs as it is."""
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
    numpy_params,
    rel_err,
    seeded_images,
)
from pnpinversion_tpu import configs as jconfigs
from pnpinversion_tpu.editors import bld_editor as jbld
from pnpinversion_tpu.models.clip_text import clip_text_apply, init_clip_text_params
from pnpinversion_tpu.models.unet import enumerate_sites as jax_sites
from pnpinversion_tpu.models.unet import init_unet_params, unet_apply
from pnpinversion_tpu.schedulers import ddim as jddim
from pnpinversion_tpu_torch import configs
from pnpinversion_tpu_torch.convert import from_jax_params
from pnpinversion_tpu_torch.editors import bld_editor as tbld
from pnpinversion_tpu_torch.models.unet import enumerate_sites
from pnpinversion_tpu_torch.parallel.sweep import BatchedBLD
from pnpinversion_tpu_torch.schedulers import ddim as tddim

torch.set_num_threads(2)

STEPS = 4
SEED = 42  # the editor's default
# f32 on both sides, relative to max |JAX|: forward-only functions
RTOL = 1e-5
PROMPTS = ("a dog on a mat", "a red bird in a tree")


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _masks(n: int, size: int = 16) -> np.ndarray:
    """n ragged {0, 1} masks (size, size), each a different blob."""
    yy, xx = np.mgrid[:size, :size]
    return np.stack([((yy - 5 - 2 * i) ** 2 + (xx - 9 + 3 * i) ** 2 < (4 + i) ** 2)
                     .astype(np.float32) for i in range(n)])


def jax_bld_noise(seed: int, shape, steps: int, dtype=jnp.float32) -> list:
    """The noise ``bld_sample`` draws for one image: the start latents from
    the first key of split(PRNGKey(seed)), then one draw per blended step
    from the loop key's successive splits."""
    k0, key = jax.random.split(jax.random.PRNGKey(seed))
    out = [np.array(jax.random.normal(k0, shape, dtype))]
    for _ in range(steps):
        key, kn = jax.random.split(key)
        out.append(np.array(jax.random.normal(kn, shape, dtype)))
    return out


@pytest.fixture
def shared_noise(monkeypatch):
    """Replace the port's draws in ``bld_editor`` by JAX's values for
    ``SEED``: install(n_blended_steps) before a run."""
    def install(steps, seed=SEED, shape=(1, 8, 8, 4)):
        table = iter(jax_bld_noise(seed, shape, steps))
        monkeypatch.setattr(tbld, "draw_noise",
                            lambda gen, shape, dtype: torch.from_numpy(next(table)).to(dtype))
    return install


@pytest.fixture(scope="module")
def pipes():
    return jax_torch_pipelines(seed=301, steps=STEPS)


def test_sd21_constants_match_jax():
    """SD21_UNET, SD21_TEXT and SD21 field by field, and the per-level heads
    (5, 10, 20 at 64^2, 32^2, 16^2) of the two packages' site lists."""
    for name in ("SD21_UNET", "SD21_TEXT"):
        assert dataclasses.asdict(getattr(configs, name)) == dataclasses.asdict(
            getattr(jconfigs, name)), name
    assert configs.SD21.name == jconfigs.SD21.name == "sd21"
    assert dataclasses.asdict(configs.SD21.vae) == dataclasses.asdict(jconfigs.SD21.vae)
    assert configs.SD21.unet == configs.SD21_UNET and configs.SD21.text == configs.SD21_TEXT
    got = [(s.heads, s.resolution, s.place_index, s.lb_slot) for pair in
           enumerate_sites(configs.SD21_UNET) for s in pair]
    want = [(s.heads, s.resolution, s.place_index, s.lb_slot) for pair in
            jax_sites(jconfigs.SD21_UNET) for s in pair]
    assert got == want
    assert [p[0].heads for p in enumerate_sites(configs.SD21_UNET)] == [
        5, 5, 10, 10, 20, 20, 20, 20, 20, 20, 10, 10, 10, 5, 5, 5]


def test_head_dim_unet_and_gelu_text_tower_match_jax():
    """A TINY UNet with 16-dim heads (2 and 4 heads a level) and a TINY text
    tower with exact GELU, the JAX weights carried across: eps and the
    hidden states within 1e-5 of max."""
    ucfg_j = dataclasses.replace(jconfigs.TINY_UNET, head_dim=16)
    tcfg_j = dataclasses.replace(jconfigs.TINY_TEXT, activation="gelu")
    ucfg_t = dataclasses.replace(configs.TINY_UNET, head_dim=16)
    tcfg_t = dataclasses.replace(configs.TINY_TEXT, activation="gelu")
    assert [p[0].heads for p in enumerate_sites(ucfg_t)] == [2, 4, 4, 4, 4, 2, 2]
    uparams = numpy_params(init_unet_params, ucfg_j, 302)
    tparams = numpy_params(init_clip_text_params, tcfg_j, 303)
    rng = np.random.RandomState(304)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    ids = rng.randint(0, 128, (2, 77))
    want, _ = unet_apply(jax.tree.map(jnp.asarray, uparams), jnp.asarray(x), jnp.int32(501),
                         jnp.asarray(ctx), ucfg_j)
    with torch.no_grad():
        got, _ = from_jax_params(uparams, ucfg_t)(_t(x), 501, _t(ctx))
    assert rel_err(got, want) <= RTOL
    want_h = clip_text_apply(jax.tree.map(jnp.asarray, tparams), jnp.asarray(ids), tcfg_j)
    with torch.no_grad():
        got_h = from_jax_params(tparams, tcfg_t)(torch.as_tensor(ids))
    assert rel_err(got_h, want_h) <= RTOL


def test_add_noise_matches_jax():
    """q(x_t | x_0) at every timestep of the 50-step schedule."""
    js, ts = jddim.make_ddim_schedule(50), tddim.make_ddim_schedule(50)
    rng = np.random.RandomState(305)
    x0, noise = rng.randn(2, 1, 8, 8, 4).astype(np.float32), rng.randn(2, 1, 8, 8, 4)
    for t in ts.timesteps:
        want = jddim.add_noise(js, jnp.asarray(x0), jnp.asarray(noise, jnp.float32),
                               jnp.int32(t))
        got = tddim.add_noise(ts, _t(x0), _t(noise), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_latent_mask_is_pil_nearest():
    """The mask goes to the latent size with PIL's nearest, which picks the
    centre pixel of each 8x8 cell (8i + 4), not ``F.interpolate``'s (8i);
    a 3-channel mask reads channel 0."""
    rng = np.random.RandomState(306)
    mask = (rng.rand(512, 512) > 0.5).astype(np.float32)
    got = tbld.latent_mask(np.stack([mask, 1 - mask, mask], axis=-1), 64)
    assert got.shape == (64, 64, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., 0], mask[4::8, 4::8])
    interp = torch.nn.functional.interpolate(_t(mask)[None, None], size=(64, 64))[0, 0]
    assert not np.array_equal(interp.numpy(), got[..., 0])


def test_bld_sample_matches_jax(pipes, shared_noise):
    """The blended loop on shared noise, mask and context: one image against
    JAX's ``bld_sample`` (its jitted program), within 1e-5 of max."""
    jpipe, tpipe = pipes
    rng = np.random.RandomState(307)
    src = rng.randn(1, 8, 8, 4).astype(np.float32)
    mask = (rng.rand(8, 8, 1) > 0.4).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    want = jax.jit(lambda p, s, m, c: jbld.bld_sample(
        p, jpipe.schedule, jpipe.config.unet, s, m, c, 7.5, jax.random.PRNGKey(SEED)))(
        jpipe.params["unet"], src, mask, ctx)
    n = tbld.bld_unet_calls(STEPS)
    assert n == 3
    shared_noise(n)
    with torch.no_grad():
        got = tbld.bld_sample(tpipe.unet, tpipe.schedule, _t(src)[None], _t(mask)[None],
                              _t(ctx)[None], 7.5, None)
    assert got.shape == (1, 1, 8, 8, 4)
    assert rel_err(got[0], want) <= RTOL


def test_editor_strip_matches_jax(pipes, shared_noise):
    """``BlendedLatentDiffusionEditor`` in both packages on one image and a
    ragged mask: [instruction | original | zeros | edit], the zero panel
    exact, the edit within the strips' one-level rule."""
    jpipe, tpipe = pipes
    img = seeded_images(308, 1)[0]
    mask = _masks(1)[0]
    want = np.asarray(jbld.BlendedLatentDiffusionEditor(jpipe)(tbld.METHOD, img, mask,
                                                               PROMPTS[0]))
    shared_noise(tbld.bld_unet_calls(STEPS))
    got = tbld.BlendedLatentDiffusionEditor(tpipe)(tbld.METHOD, img, mask, PROMPTS[0])
    assert_strips_match(got, want)
    assert not got[:, 32:48].any()
    with pytest.raises(NotImplementedError):
        tbld.BlendedLatentDiffusionEditor(tpipe)("ddim+bld", img, mask, PROMPTS[0])


def test_batched_bld_matches_single_editor(pipes):
    """``BatchedBLD`` on 2 images, each with its own mask and prompt, against
    the port's single-image editor (the generator's own draws, shared by the
    images), within ``assert_panels_close``'s 2 levels."""
    _, tpipe = pipes
    imgs, masks = seeded_images(309, 2), _masks(2)
    cond = torch.stack([tpipe.encode_prompt([p]) for p in PROMPTS])
    lat_masks = np.stack([tbld.latent_mask(m, tpipe.latent_size) for m in masks])
    edits = BatchedBLD(tpipe).edit_batch(imgs, lat_masks, cond, 7.5)
    assert edits.shape == (2, 16, 16, 3) and edits.dtype == np.uint8
    editor = tbld.BlendedLatentDiffusionEditor(tpipe)
    for i in range(2):
        strip = editor(tbld.METHOD, imgs[i], masks[i], PROMPTS[i])
        assert_panels_close(edits[i], strip[:, 48:])
