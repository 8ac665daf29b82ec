"""Edit-friendly DDPM in the PyTorch port vs the JAX package, at TINY with 3
DDIM steps on the steps_offset=1 schedule (timesteps 667, 334, 1), f32 on the
CPU: the variance, the noisings of x0, noise-map extraction and the
re-injecting reverse pass under EF's P2P control at N = 1 and N = 2 images,
the P2P control's self-attention size limit at SD1.4's sites, the editor's
strip, and ``BatchedEditFriendly`` against the port's single-image editor.

The JAX package draws its noise from ``jax.random``, the port from a
``torch.Generator``: here both take one numpy noise (``jax.random.normal``
and the port's ``sample_xts_from_x0`` are replaced while the module runs)."""
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
from pnpinversion_tpu.control.base import AttnSite as JaxSite
from pnpinversion_tpu.control.p2p import make_p2p_control as jax_make_p2p_control
from pnpinversion_tpu.editors.ef_editor import EditFriendlyEditor as JaxEFEditor
from pnpinversion_tpu.inversion import ef_ddpm as jef
from pnpinversion_tpu.schedulers import ddim as jddim
from pnpinversion_tpu_torch.control.base import NO_CONTROL, AttnSite
from pnpinversion_tpu_torch.control.p2p import make_p2p_control, stack_tensors
from pnpinversion_tpu_torch.editors.ef_editor import METHOD, EditFriendlyEditor, ef_control
from pnpinversion_tpu_torch.inversion import ef_ddpm as tef
from pnpinversion_tpu_torch.parallel.sweep import BatchedEditFriendly
from pnpinversion_tpu_torch.schedulers import ddim as tddim
from pnpinversion_tpu_torch.utils.tokenizer import default_tokenizer

torch.set_num_threads(2)

STEPS = 3
SKIP = 1  # the editor's 12 would leave no step at 3; Z = 2 reverse steps
Z = STEPS - SKIP
SCALES = (1.0, 7.5)  # the editor's source and target guidance
# f32 on both sides, relative to max |reference|, as test_torch_sampling.py
RTOL = 1e-4
# two replace edits (as many words) with tensors of their own, and a refine
PROMPTS = [("a cat on a mat", "a dog on a mat"), ("a red car", "a blue car")]
REFINE = ("a cat on a mat", "a big cat on a red mat")
NOISE = np.random.RandomState(101).randn(STEPS, 1, 8, 8, 4).astype(np.float32)
DRAW = tef.sample_xts_from_x0  # the port's draw, before the fixture replaces it


@pytest.fixture(scope="module", autouse=True)
def shared_noise():
    """Both packages' draws of EF's noise replaced by NOISE (JAX's draws of
    other shapes, the weight inits', as they were)."""
    draw = jax.random.normal

    def normal(key, shape, dtype=jnp.float32):
        if tuple(shape) != NOISE.shape:
            return draw(key, shape, dtype)
        return jnp.asarray(NOISE, dtype)

    def xts(generator, schedule, x0):
        return tef.xts_from_noise(schedule, x0, torch.from_numpy(NOISE).to(x0.dtype))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        mp.setattr(tef, "sample_xts_from_x0", xts)
        yield


@pytest.fixture(scope="module")
def setup():
    jpipe, tpipe = jax_torch_pipelines(seed=103, steps=STEPS)
    jed, ted = JaxEFEditor(jpipe), EditFriendlyEditor(tpipe)
    assert ted.schedule.timesteps == tuple(int(t) for t in jed.schedule.timesteps) == (667, 334, 1)
    rng = np.random.RandomState(104)
    arrays = dict(x0=rng.randn(2, 1, 8, 8, 4).astype(np.float32) * 0.5,
                  cond=rng.randn(2, 2, 77, 32).astype(np.float32),
                  uncond=rng.randn(2, 2, 77, 32).astype(np.float32),
                  zs=rng.randn(2, Z, 1, 8, 8, 4).astype(np.float32))
    return jed, ted, arrays


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def test_ddim_variance_steps_offset():
    """sigma_t^2 at every timestep of the steps_offset=1 schedules, the last
    (t = 1) with the final alpha as alpha_prev."""
    for steps in (STEPS, 50):
        js = jddim.make_ddim_schedule(num_steps=steps, steps_offset=1)
        ts = tddim.make_ddim_schedule(num_steps=steps, steps_offset=1)
        assert ts.timesteps[-1] == 1
        got = np.array([tddim.ddim_variance(ts, t) for t in ts.timesteps], np.float32)
        want = np.asarray(jax.vmap(lambda t: jddim.ddim_variance(js, t))(js.timesteps))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_sample_xts_matches_jax(setup):
    """The noisings of x0 on shared noise, each image with the same draw."""
    jed, ted, arr = setup
    x0 = arr["x0"]
    got = tef.xts_from_noise(ted.schedule, _t(x0), _t(NOISE))
    assert got.shape == (2, STEPS + 1, 1, 8, 8, 4) and got.dtype == torch.float32
    for i in range(2):
        want = jef.sample_xts_from_x0(None, jed.schedule, jnp.asarray(x0[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_generator_draw_is_one_image_noise(setup):
    """The port's own draw: one image's noise from the generator, shared by
    the images of a batch."""
    _, ted, arr = setup
    x0 = _t(arr["x0"])
    got = DRAW(torch.Generator().manual_seed(5), ted.schedule, x0)
    noise = torch.randn((STEPS, 1, 8, 8, 4), generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(got, tef.xts_from_noise(ted.schedule, x0, noise), rtol=0, atol=0)
    torch.testing.assert_close(got[1:2], DRAW(torch.Generator().manual_seed(5), ted.schedule,
                                              x0[1:2]), rtol=0, atol=0)


def test_forward_process_matches_jax(setup):
    """Noise-map extraction at N = 2 and N = 1 against the JAX editor's own
    program (source guidance 1, eta 1) on the shared noise."""
    jed, ted, arr = setup
    fwd = jed._forward_fn(1.0)
    want = [fwd(jed.pipe.params["unet"], jnp.asarray(arr["x0"][i]),
                jnp.asarray(arr["cond"][i, :1]), jnp.asarray(arr["uncond"][i, :1]),
                jnp.asarray(SCALES[0], jnp.float32), None) for i in range(2)]
    for n in (2, 1):
        with torch.inference_mode():
            zs, xts = tef.ef_forward_process(
                ted.pipe.unet, ted.schedule, _t(arr["x0"][:n]), _t(arr["cond"][:n, :1]),
                _t(arr["uncond"][:n, :1]), SCALES[0], eta=1.0)
        assert zs.shape == (n, STEPS, 1, 8, 8, 4) and xts.shape == (n, STEPS + 1, 1, 8, 8, 4)
        assert not zs[:, 0].any()
        for i in range(n):
            assert rel_err(zs[i], want[i][0]) <= RTOL
            assert rel_err(xts[i], want[i][1]) <= RTOL


def _ef_controls(jed, ted, prompts):
    """(the JAX spec and tensors, the port's control and stacked tensors) of
    EF's P2P control for one prompt pair per image. Each package's tokenizer
    numbers words as it first sees them, so both see the same prompts."""
    jcs = [jax_make_p2p_control(list(p), jed.pipe.tokenizer, num_steps=STEPS,
                                is_replace_controller=True, num_lb_slots=ted.pipe.num_lb_slots,
                                lb_res=ted.pipe.lb_res, latent_size=ted.pipe.latent_size,
                                self_edit_max_seq=16 * 16) for p in prompts]
    tcs = [ef_control(ted.pipe, list(p), STEPS) for p in prompts]
    assert len({c.spec for c, _ in tcs}) == 1 and tcs[0][0].spec.kind == "replace"
    return jcs, tcs[0][0], stack_tensors([t for _, t in tcs])


def test_reverse_process_matches_jax(setup):
    """The re-injecting reverse pass under EF's P2P control, per-row
    guidance (1, 7.5), at N = 2 with a prompt pair per image and at N = 1,
    against the JAX editor's program; the control acts."""
    jed, ted, arr = setup
    jcs, control, tensors = _ef_controls(jed, ted, PROMPTS)
    xT = arr["x0"]  # any start latent
    want = [jed._reverse_fn(jcs[i][0].spec, 1.0, Z)(
        jed.pipe.params["unet"], jnp.asarray(xT[i]), jnp.asarray(arr["zs"][i]),
        jnp.asarray(arr["cond"][i]), jnp.asarray(arr["uncond"][i]),
        jnp.asarray(SCALES, jnp.float32), jcs[i][1]) for i in range(2)]

    def run(n, ctrl=control, t=tensors):
        with torch.inference_mode():
            return tef.ef_reverse_process(
                ted.pipe.unet, ted.schedule, _t(xT[:n]), _t(arr["zs"][:n]), _t(arr["cond"][:n]),
                _t(arr["uncond"][:n]), SCALES, eta=1.0, control=ctrl,
                tensors={k: v[:n] for k, v in t.items()}, num_zs=Z)

    for n in (2, 1):
        got = run(n)
        assert got.shape == (n, 2, 8, 8, 4)
        for i in range(n):
            assert rel_err(got[i], want[i]) <= RTOL
    assert rel_err(run(1, NO_CONTROL, {}), got) > 1e-3


def _override(ctrl, site, q, step=0):
    return ctrl.attention_override(site, q, q, q, 0.25, {}, {}, step)


def test_self_edit_max_seq_at_sd14_sites():
    """EF's copy of the P2P control replaces self-attention at 16^2 maps and
    leaves 32^2 alone; P2P's default still replaces at 32^2; neither at 64^2.
    At 16^2 the port's override equals the JAX package's."""
    prompts = list(PROMPTS[0])
    ef, _ = make_p2p_control(prompts, default_tokenizer(), num_steps=10,
                             self_edit_max_seq=16 * 16)
    p2p, _ = make_p2p_control(prompts, default_tokenizer(), num_steps=10)
    jef_ctrl, _ = jax_make_p2p_control(prompts, default_tokenizer(), num_steps=10,
                                       self_edit_max_seq=16 * 16)
    assert ef.spec.self_edit_max_seq == jef_ctrl.spec.self_edit_max_seq == 256
    assert p2p.spec.self_edit_max_seq == 32 * 32
    rng = np.random.RandomState(105)
    for res, ef_acts, p2p_acts in ((16, True, True), (32, False, True), (64, False, False)):
        site = dict(index=12, place="up", resolution=res, is_cross=False, heads=1)
        q = rng.randn(4, 1, res * res, 8).astype(np.float32)
        got = _override(ef, AttnSite(**site), _t(q))
        assert (got is not None) == ef_acts
        assert (_override(p2p, AttnSite(**site), _t(q)) is not None) == p2p_acts
        want = _override(jef_ctrl, JaxSite(**site), jnp.asarray(q), jnp.int32(0))
        assert (want is not None) == ef_acts
        if res == 16:
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
            # inside the replace window the edited row takes the source's probs
            assert not np.allclose(got[0][3].numpy(), _override(
                ef, AttnSite(**site), _t(q), step=9)[0][3].numpy())


@pytest.mark.parametrize("prompts", [PROMPTS[0], REFINE], ids=["replace", "refine"])
def test_editor_strip(setup, prompts):
    jed, ted, _ = setup
    img = seeded_images(106, 1)[0]
    kw = dict(skip=SKIP, seed=7)
    assert_strips_match(ted(METHOD, img, *prompts, **kw),
                        np.asarray(jed(METHOD, img, *prompts, **kw)))
    with pytest.raises(NotImplementedError):
        ted("edit-friendly-inversion+masactrl", img, *prompts)


def test_batched_matches_single_editor(setup):
    """Two images with their own prompts through one batched edit == each
    through the single-image editor."""
    jed, ted, _ = setup
    pipe, size = ted.pipe, ted.pipe.config.image_size
    imgs = seeded_images(107, 2)
    _, control, tensors = _ef_controls(jed, ted, PROMPTS)
    cond = torch.stack([pipe.encode_prompt(list(p)) for p in PROMPTS])
    src, edit = BatchedEditFriendly(pipe, skip=SKIP).edit_batch(control.spec, imgs, cond,
                                                                 *SCALES, tensors)
    for i, p in enumerate(PROMPTS):
        want = ted(METHOD, imgs[i], *p, skip=SKIP)[:, 2 * size:]
        assert_panels_close(np.concatenate([src[i], edit[i]], axis=1), want)


@pytest.fixture(scope="module")
def bf16_setup():
    jpipe, tpipe = jax_torch_pipelines(seed=103, steps=STEPS, bf16=True)
    return JaxEFEditor(jpipe), EditFriendlyEditor(tpipe)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def test_bf16_pipeline_latents_match_jax(setup, bf16_setup):
    """On a bf16 pipeline (the same bf16-rounded weights in both packages)
    the JAX package's f32 alphas make EF's latents f32, and its layers then
    run the UNet on them in f32; the port's layers cast their weights the
    same way, so its two passes run the bf16 pipeline's UNet in f32. Noise
    maps, trajectory and the reverse pass under EF's P2P control match the
    JAX editor's programs within the f32 loops' 1e-4 of max (bf16 inputs:
    image latent, embeddings, guidance)."""
    _, _, arr = setup
    jed, ted = bf16_setup
    unet = ted.pipe.unet
    assert ted.pipe.dtype == torch.bfloat16 and unet.conv_in.weight.dtype == torch.bfloat16
    bf = jnp.bfloat16
    zs_w, xts_w = jed._forward_fn(1.0)(
        jed.pipe.params["unet"], jnp.asarray(arr["x0"][0], bf), jnp.asarray(arr["cond"][0, :1], bf),
        jnp.asarray(arr["uncond"][0, :1], bf), jnp.asarray(SCALES[0], bf), None)
    assert zs_w.dtype == xts_w.dtype == jnp.float32
    with torch.inference_mode():
        zs, xts = tef.ef_forward_process(unet, ted.schedule, _bf16(arr["x0"][:1]),
                                         _bf16(arr["cond"][:1, :1]), _bf16(arr["uncond"][:1, :1]),
                                         SCALES[0], eta=1.0)
    assert rel_err(zs[0], zs_w) <= RTOL and rel_err(xts[0], xts_w) <= RTOL
    jcs, control, tensors = _ef_controls(jed, ted, PROMPTS[:1])
    want = jed._reverse_fn(jcs[0][0].spec, 1.0, Z)(
        jed.pipe.params["unet"], jnp.asarray(arr["x0"][0]), jnp.asarray(arr["zs"][0]),
        jnp.asarray(arr["cond"][0], bf), jnp.asarray(arr["uncond"][0], bf),
        jnp.asarray(SCALES, bf), jcs[0][1])
    with torch.inference_mode():
        got = tef.ef_reverse_process(unet, ted.schedule, _t(arr["x0"][:1]), _t(arr["zs"][:1]),
                                     _bf16(arr["cond"][:1]), _bf16(arr["uncond"][:1]), SCALES,
                                     eta=1.0, control=control, tensors=tensors, num_zs=Z)
    assert got.dtype == torch.float32 and rel_err(got[0], want) <= RTOL
