"""InstructPix2Pix and InstructDiffusion in the PyTorch port vs the JAX
package, f32 on the CPU at TINY with an 8-channel UNet and 3 sampling steps:
the IP2P config, the k-diffusion sigma grid, timesteps and ancestral steps,
the unscaled VAE mean, one 8-channel UNet call at a continuous timestep,
``instruct_sample`` for both variants and both editors' strips on one noise
sequence, and ``BatchedInstruct`` against the port's single-image editor.

The JAX package draws its noise from ``jax.random``, the port from a
``torch.Generator``. For the parity tests both take their draws from one
numpy table: JAX's ``jax.random.normal`` (at one image's noise shape) returns
the table row that its key picks, and the port's ``draw_noise`` returns the
rows of the same keys in the same order (the JAX sampler's key splits,
replayed on the host)."""
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
from pnpinversion_tpu import configs as jconfigs
from pnpinversion_tpu.editors import instruct_editor as jie
from pnpinversion_tpu.models.unet import unet_apply
from pnpinversion_tpu.models.vae import vae_encode
from pnpinversion_tpu.sampling import kdiffusion as jkd
from pnpinversion_tpu.schedulers.ddim import make_ddim_schedule as jax_schedule
from pnpinversion_tpu_torch import configs
from pnpinversion_tpu_torch.editors import instruct_editor as tie
from pnpinversion_tpu_torch.parallel.sweep import BatchedInstruct
from pnpinversion_tpu_torch.sampling import kdiffusion as tkd
from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule

torch.set_num_threads(2)

STEPS = 3
SEED = 1234  # the editors' default
# f32 on both sides, relative to max |reference|, as the other loops' tests
RTOL = 1e-4
SHAPE = (1, 8, 8, 4)  # one image's latent: the shape of every noise draw
TABLE = np.random.RandomState(131).randn(16, *SHAPE).astype(np.float32)
INSTRUCTION = "make the cat a dog"


def _row(key):
    return jax.random.randint(key, (), 0, TABLE.shape[0])


def _rows_of_seed(seed: int, steps: int):
    """The table rows the JAX sampler's draws pick: its first draw's key,
    then each step's (``instruct_sample`` and ``sample_euler_ancestral``'s
    splits)."""
    k0, key = jax.random.split(jax.random.PRNGKey(seed))
    rows = [int(_row(k0))]
    for _ in range(steps):
        key, kn = jax.random.split(key)
        rows.append(int(_row(kn)))
    return rows


class NoiseSequence:
    """The port's draws: the table rows of ``rows`` in order, from the start
    again after ``reset``."""

    def __init__(self, rows):
        self.rows, self.i = rows, 0

    def reset(self):
        self.i = 0

    def __call__(self, generator, shape, dtype):
        assert tuple(shape) == SHAPE
        row = self.rows[self.i]
        self.i += 1
        return torch.from_numpy(TABLE[row]).to(dtype)


@pytest.fixture
def shared_noise():
    draw = jax.random.normal
    seq = NoiseSequence(_rows_of_seed(SEED, STEPS))

    def normal(key, shape, dtype=jnp.float32):
        if tuple(shape) != SHAPE:
            return draw(key, shape, dtype)
        return jnp.asarray(TABLE, dtype)[_row(key)]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        mp.setattr(tie, "draw_noise", seq)
        yield seq


@pytest.fixture(scope="module")
def setup():
    jpipe, tpipe = jax_torch_pipelines(seed=132, steps=STEPS, in_channels=8)
    return jie.InstructEditor(jpipe), tie.InstructEditor(tpipe)


def test_ip2p_config_matches_jax():
    """IP2P: SD1.4 with an 8-channel UNet input, field for field."""
    assert dataclasses.asdict(configs.IP2P) == dataclasses.asdict(jconfigs.IP2P)
    assert configs.IP2P.unet.in_channels == 8 and configs.IP2P.unet.out_channels == 4
    assert dataclasses.replace(configs.IP2P.unet, in_channels=4) == configs.SD14.unet


@pytest.mark.parametrize("n", [STEPS, 50])
def test_sigmas_match_jax(n):
    """The descending sigma grid with its final 0 and the continuous timestep
    of each sigma and of sigmas between the grid's (f32 on both sides: 1e-6
    relative; timesteps within 1e-3 of 0..999)."""
    ts, js = make_ddim_schedule(50), jax_schedule(50)
    got = tkd.get_sigmas(ts, n)
    want = np.asarray(jkd.get_sigmas(js, n))
    assert got.dtype == np.float32 and got.shape == (n + 1,) and got[-1] == 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    probes = np.concatenate([got[:-1], np.exp(np.random.RandomState(133).uniform(
        np.log(got[-2]), np.log(got[0]), 8))]).astype(np.float32)
    for sigma in probes:
        t = tkd.sigma_to_t(ts, sigma)
        assert isinstance(t, float)
        assert abs(t - float(jkd.sigma_to_t(js, jnp.asarray(sigma)))) <= 1e-3
    for a, b in zip(got[:-1], got[1:]):
        np.testing.assert_allclose(tkd.get_ancestral_step(a, b),
                                   [float(x) for x in jkd.get_ancestral_step(a, b)],
                                   rtol=1e-6, atol=1e-7)


def test_unet_8ch_float_timestep_and_unscaled_mean(setup):
    """One UNet call on 8 channels at a timestep between integers (the
    embedding sees the float), against JAX's, and the unscaled posterior
    mean of the VAE (1e-4 of max, f32)."""
    jed, ted = setup
    assert ted.pipe.unet.conv_in.weight.shape[1] == 8
    rng = np.random.RandomState(134)
    x = rng.randn(3, 8, 8, 8).astype(np.float32)
    ctx = rng.randn(3, 77, 32).astype(np.float32)
    t = 537.25
    with torch.inference_mode():
        got, _ = ted.pipe.unet(torch.from_numpy(x), t, torch.from_numpy(ctx))
        moved, _ = ted.pipe.unet(torch.from_numpy(x), 537.0, torch.from_numpy(ctx))
    want, _ = jax.jit(lambda p, a, c: unet_apply(p, a, jnp.asarray(t, jnp.float32), c,
                                                 jed.pipe.config.unet))(
        jed.pipe.params["unet"], jnp.asarray(x), jnp.asarray(ctx))
    assert got.shape == (3, 8, 8, 4) and rel_err(got, want) <= RTOL
    assert rel_err(moved, want) > 10 * rel_err(got, want)
    img = seeded_images(135, 2).astype(np.float32) / 127.5 - 1.0
    with torch.inference_mode():
        mean = ted.pipe.vae.encode(torch.from_numpy(img), scale=False)
        scaled = ted.pipe.vae.encode(torch.from_numpy(img))
    assert rel_err(mean, vae_encode(jed.pipe.params["vae"], jnp.asarray(img),
                                    jed.pipe.config.vae, scale=False)) <= RTOL
    torch.testing.assert_close(scaled, mean * 0.18215)


def _jax_sample_fn(jed, variant):
    """The JAX editor's own jitted sampler (the program its ``edit`` runs)."""
    pipe = jed.pipe
    return jed._jit(("sample", variant, STEPS), lambda: jax.jit(
        lambda p, ic, tc, tu, ct, ci, r: jie.instruct_sample(
            p, pipe.schedule, pipe.config.unet, ic, tc, tu, STEPS, ct, ci, r, variant)))


@pytest.mark.parametrize("method", list(tie.VARIANTS))
def test_instruct_sample_matches_jax(setup, shared_noise, method):
    """Both guidance combinations at N = 2 images (each with its own image
    conditioning and instruction; one noise sequence shared, as the JAX
    batched class shares its key) against JAX's per image."""
    jed, ted = setup
    variant, ct, ci = tie.VARIANTS[method]
    rng = np.random.RandomState(136)
    image_cond = rng.randn(2, *SHAPE).astype(np.float32)
    text = rng.randn(2, 1, 77, 32).astype(np.float32)
    uncond = rng.randn(1, 77, 32).astype(np.float32)
    with torch.inference_mode():
        got = tie.instruct_sample(ted.pipe.unet, ted.pipe.schedule, torch.from_numpy(image_cond),
                                  torch.from_numpy(text), torch.from_numpy(uncond)[None].expand(
                                      2, -1, -1, -1), STEPS, ct, ci, None, variant)
    assert got.shape == (2,) + SHAPE and got.dtype == torch.float32
    fn = _jax_sample_fn(jed, variant)
    for i in range(2):
        want = fn(jed.pipe.params["unet"], jnp.asarray(image_cond[i]), jnp.asarray(text[i]),
                  jnp.asarray(uncond), jnp.asarray(ct, jnp.float32), jnp.asarray(ci, jnp.float32),
                  jax.random.PRNGKey(SEED))
        assert rel_err(got[i], want) <= RTOL


@pytest.mark.parametrize("method", list(tie.VARIANTS))
def test_editor_strip(setup, shared_noise, method):
    """Both editors' strips; the JAX editor runs the sampler program of the
    test above."""
    jed, ted = setup
    img = seeded_images(137, 1)[0]
    got = ted(method, img, INSTRUCTION, steps=STEPS)
    assert_strips_match(got, np.asarray(jed(method, img, INSTRUCTION, steps=STEPS)))
    assert not got[:, 32:48].any()  # the third panel is zeros
    with pytest.raises(NotImplementedError):
        ted("instruct-masactrl", img, INSTRUCTION)


@pytest.mark.parametrize("method", list(tie.VARIANTS))
def test_batched_matches_single_editor(setup, method):
    """Two images with their own instructions through one batched edit ==
    each through the single-image editor (the generator's own noise: one
    draw per step shared by the images, as the editor draws for one)."""
    _, ted = setup
    pipe = ted.pipe
    imgs = seeded_images(138, 2)
    instructions = [INSTRUCTION, "turn it into winter"]
    text = torch.stack([pipe.encode_prompt([s]) for s in instructions])
    edits = BatchedInstruct(pipe, steps=STEPS).edit_batch(method, imgs, text)
    assert edits.shape == (2, 16, 16, 3) and edits.dtype == np.uint8
    for i, s in enumerate(instructions):
        assert_panels_close(edits[i], ted(method, imgs[i], s, steps=STEPS)[:, 48:])
    with pytest.raises(NotImplementedError):
        BatchedInstruct(pipe).edit_batch("instruct-masactrl", imgs, text)
