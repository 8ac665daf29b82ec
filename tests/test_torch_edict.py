"""EDICT in the PyTorch port vs the JAX package, f32 on the CPU at TINY with 4
DDIM steps (the edit's strength 0.8 starts it at step 1): the f32 step and
mixing layers and their exact inverses, the float64 coefficients and mixing
layers against the JAX double-float ``hi + lo``, the takeover tensors and
both control hooks at N = 2 images (the JAX side under ``jax.vmap``),
``coupled_scan`` in both precisions (the port's float64 carry against the
JAX double-float one), the float64 round trip against the f32 one, both
editors' strips, and ``BatchedEDICT`` against the port's single-image
editor. The JAX sides call the JAX editors' own jitted programs, so a
function test and a strip share one compile."""
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
from pnpinversion_tpu.control import edict_p2p as jep
from pnpinversion_tpu.control.base import AttnSite as JaxSite
from pnpinversion_tpu.editors.edict_editor import EDICTEditor as JaxEDICTEditor
from pnpinversion_tpu.schedulers import edict as jedict
from pnpinversion_tpu.schedulers import edict_df as jdf
from pnpinversion_tpu.schedulers.ddim import make_ddim_schedule as jax_schedule
from pnpinversion_tpu_torch.control import edict_p2p as tep
from pnpinversion_tpu_torch.control.base import AttnSite
from pnpinversion_tpu_torch.control.p2p import stack_tensors
from pnpinversion_tpu_torch.editors.edict_editor import METHODS, EDICTEditor, coupled_scan
from pnpinversion_tpu_torch.parallel.sweep import BatchedEDICT
from pnpinversion_tpu_torch.schedulers import edict as tedict
from pnpinversion_tpu_torch.schedulers import edict_df as tdf
from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule
from pnpinversion_tpu_torch.utils.tokenizer import default_tokenizer

torch.set_num_threads(2)

STEPS = 4
T_LIMIT = STEPS - int(STEPS * 0.8)  # the edit's first step
MW = 0.93
# f32 on both sides, relative to max |reference|, as the other loops' tests
RTOL = 1e-4
PROMPTS = [("a cat on a mat", "a dog on a mat"), ("a red car", "a big blue car")]
H, RES, D = 2, 4, 8


@pytest.fixture(scope="module")
def setup():
    """(JAX pipeline, port pipeline, the JAX editors by precision, seeded
    arrays): pair (2 images, 2 latents), [uncond, cond] and edit contexts."""
    jpipe, tpipe = jax_torch_pipelines(seed=111, steps=STEPS)
    jeds = {p: JaxEDICTEditor(jpipe, precision=p) for p in ("f32", "df64")}
    rng = np.random.RandomState(112)
    lat = rng.randn(2, 1, 8, 8, 4).astype(np.float32) * 0.5
    arrays = dict(pair=np.concatenate([lat, lat + 0.1 * rng.randn(*lat.shape)], 1)
                  .astype(np.float32),
                  ctx=rng.randn(2, 2, 77, 32).astype(np.float32),
                  edit=rng.randn(2, 1, 77, 32).astype(np.float32))
    return jpipe, tpipe, jeds, arrays


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_steps_match_jax_and_invert(reverse):
    """The f32 steps at timesteps of the 50-step schedule (t = 0 takes the
    final alpha) against JAX's, 1e-6 of max; each undoes the other, 1e-5."""
    ts, js = make_ddim_schedule(50), jax_schedule(50)
    rng = np.random.RandomState(113)
    x, eps = (rng.randn(2, 8, 8, 4).astype(np.float32) for _ in range(2))
    step, inverse = ((tedict.edict_reverse_step, tedict.edict_forward_step) if reverse
                     else (tedict.edict_forward_step, tedict.edict_reverse_step))
    jstep = jedict.edict_reverse_step if reverse else jedict.edict_forward_step
    for t in (980, 500, 20, 0):
        got = step(ts, _t(eps), t, _t(x))
        want = jstep(js, jnp.asarray(eps), jnp.asarray(t), jnp.asarray(x))
        assert rel_err(got, want) <= 1e-6
        assert rel_err(inverse(ts, _t(eps), t, got), x) <= 1e-5


def test_mix_matches_jax_and_inverts():
    """The f32 mixing layers on two images' pairs against JAX's per image,
    1e-6 of max; unmix undoes mix, 1e-5."""
    pair = np.random.RandomState(114).randn(2, 2, 8, 8, 4).astype(np.float32)
    for got_fn, want_fn in ((tedict.edict_mix, jedict.edict_mix),
                            (tedict.edict_unmix, jedict.edict_unmix)):
        got = got_fn(_t(pair), MW)
        for i in range(2):
            assert rel_err(got[i], want_fn(jnp.asarray(pair[i]), MW)) <= 1e-6
    assert rel_err(tedict.edict_unmix(tedict.edict_mix(_t(pair), MW), MW), pair) <= 1e-5


def _pass_timesteps(schedule, t_limit, reverse):
    ts = list(schedule.timesteps[t_limit:])
    return ts[::-1] if reverse else ts


@pytest.mark.parametrize("steps,t_limit,reverse", [(4, 0, False), (4, 1, True), (50, 10, False),
                                                   (50, 0, True)])
def test_df_coeffs_match_jax_hi_lo(steps, t_limit, reverse):
    """The port's float64 (A, C), taken at a pass's timesteps, against the
    JAX double-float hi + lo: equal to the double-float's ~2^-48 of relative
    precision."""
    a, c = tdf.edict_df_coeffs(_pass_timesteps(make_ddim_schedule(steps), t_limit, reverse),
                               1000 // steps, reverse)
    a_hi, a_lo, c_hi, c_lo = jdf.edict_df_coeffs(steps, t_limit, reverse)
    assert a.dtype == c.dtype == np.float64 and a.shape == (steps - t_limit,)
    np.testing.assert_allclose(a, np.float64(a_hi) + a_lo, rtol=1e-13, atol=0)
    np.testing.assert_allclose(c, np.float64(c_hi) + c_lo, rtol=1e-12, atol=1e-16)


@pytest.mark.parametrize("steps_offset", [0, 1])
@pytest.mark.parametrize("reverse", [False, True])
def test_df_coeffs_follow_the_schedule(steps_offset, reverse):
    """The float64 (A, C) are those of the timesteps the pass feeds the UNet,
    whatever the schedule's offset: against the f32 step's own quotient form
    at the schedule's alphas (f32 tables: A to 1e-6 relative, C, which
    cancels, to 1e-6 absolute)."""
    sched = make_ddim_schedule(10, steps_offset=steps_offset)
    ts = _pass_timesteps(sched, 2, reverse)
    a, c = tdf.edict_df_coeffs(ts, sched.step_ratio, reverse)
    a_t = np.array([sched.alpha_at(t) for t in ts], np.float64)
    a_prev = np.array([sched.alpha_at(t - sched.step_ratio) for t in ts], np.float64)
    q = np.sqrt(a_t / a_prev)
    want_a = q if reverse else 1.0 / q
    want_c = (np.sqrt(1 - a_t) - q * np.sqrt(1 - a_prev) if reverse
              else -np.sqrt(1 - a_t) / q + np.sqrt(1 - a_prev))
    np.testing.assert_allclose(a, want_a, rtol=1e-6)
    np.testing.assert_allclose(c, want_c, rtol=0, atol=1e-6)


def test_f64_mix_matches_jax_df_and_inverts():
    """The float64 mixing layers against the JAX double-float ones (hi + lo,
    1e-13 relative), and 50 mix/unmix round trips in float64 stay within
    1e-13 where f32's drift."""
    pair = np.random.RandomState(115).randn(1, 2, 8, 8, 4)
    x0, x1 = (jdf.DF(*(jnp.asarray(v) for v in jdf.split_array(pair[0, i]))) for i in (0, 1))
    for got_fn, want_fn in ((tdf.edict_mix_f64, jdf.edict_mix_df),
                            (tdf.edict_unmix_f64, jdf.edict_unmix_df)):
        got = got_fn(_t(pair), MW).numpy()
        for i, w in enumerate(want_fn(x0, x1, MW)):
            want = np.float64(np.asarray(w.hi)) + np.asarray(w.lo)
            np.testing.assert_allclose(got[0, i], want, rtol=1e-13, atol=1e-13)
    p64, p32 = _t(pair), _t(pair.astype(np.float32))
    for _ in range(50):
        p64 = tdf.edict_unmix_f64(tdf.edict_mix_f64(p64, MW), MW)
        p32 = tedict.edict_unmix(tedict.edict_mix(p32, MW), MW)
    err64 = (p64 - _t(pair)).abs().max().item()
    assert p64.dtype == torch.float64 and err64 < 1e-13
    assert err64 < (p32.double() - _t(pair)).abs().max().item() / 100


@pytest.mark.parametrize("prompts", [PROMPTS[0], PROMPTS[1], ("a cat", "a cat")],
                         ids=["replace", "insert", "same"])
def test_p2p_tensors_match_jax(prompts):
    """The SequenceMatcher alignment of the two prompts' tokens, bit for bit
    (both packages' word tokenizers see the same prompts in the same order)."""
    got = tep.make_edict_p2p_tensors(*prompts, default_tokenizer())
    want = jep.make_edict_p2p_tensors(*prompts, default_tokenizer())
    assert got["edit_mask"].dtype == torch.float32 and got["edit_indices"].dtype == torch.int64
    for key in ("edit_mask", "edit_indices"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert got["edit_mask"].sum() > 0


def _tensors(n, weights):
    """Two images' takeover tensors (their own prompt pairs), numpy, with
    optional token weights."""
    per = [tep.make_edict_p2p_tensors(*p, default_tokenizer()) for p in PROMPTS[:n]]
    out = {k: np.stack([t[k].numpy() for t in per]) for k in per[0]}
    if weights:
        out["token_weights"] = np.random.RandomState(116).uniform(
            0.5, 2.0, (n, 77)).astype(np.float32)
    return out


def test_qkv_hook_matches_jax_vmap():
    """Self-attention: each image's edit row takes its base row's q and k
    (bit for bit against JAX's hook under vmap), with the input's strides
    kept; cross-attention and v are left as they are."""
    rng = np.random.RandomState(117)
    q, k, v = (rng.randn(2, 3, RES * RES, H * D).astype(np.float32) for _ in range(3))
    heads = [_t(x).reshape(6, RES * RES, H, D).transpose(1, 2) for x in (q, k, v)]
    ctrl, site = tep.EdictP2PControl(STEPS), dict(index=0, place="down", resolution=RES,
                                                  is_cross=False, heads=H)
    got = ctrl.qkv_hook(AttnSite(**site), *heads, {}, {}, 0)
    split = [np.asarray(h.reshape(2, 3, H, RES * RES, D)) for h in heads]
    want = jax.vmap(lambda a, b, c: jep.EdictP2PControl(STEPS).qkv_hook(
        JaxSite(**site), a, b, c, {}, {}, 0))(*(jnp.asarray(x) for x in split))
    for g, w, h in zip(got, want, heads):
        assert g.stride() == h.stride()
        np.testing.assert_array_equal(g.reshape(2, 3, H, RES * RES, D).numpy(), np.asarray(w))
    assert got[2] is heads[2]
    cross = ctrl.qkv_hook(AttnSite(**{**site, "is_cross": True}), *heads, {}, {}, 0)
    assert all(a is b for a, b in zip(cross, heads))


@pytest.mark.parametrize("weights", [False, True], ids=["plain", "token_weights"])
def test_probs_hook_matches_jax_vmap(weights):
    """Cross-attention: each image's edit row spliced with its own base
    row's probs at its own indices and mask, against JAX's hook under vmap,
    bit for bit."""
    tensors = _tensors(2, weights)
    probs = np.random.RandomState(118).rand(2, 3, H, RES * RES, 77).astype(np.float32)
    site = AttnSite(index=0, place="down", resolution=RES, is_cross=True, heads=H)
    ctrl = tep.EdictP2PControl(STEPS)
    assert ctrl.needs_probs(site) and not ctrl.needs_probs(
        AttnSite(index=0, place="down", resolution=RES, is_cross=False, heads=H))
    got, _ = ctrl.probs_hook(site, _t(probs).reshape(6, H, RES * RES, 77),
                             {k: _t(v) for k, v in tensors.items()}, {}, 0)
    jsite = JaxSite(index=0, place="down", resolution=RES, is_cross=True, heads=H)
    want = jax.vmap(lambda p, t: jep.EdictP2PControl(STEPS).probs_hook(
        jsite, p, t, {}, 0)[0])(jnp.asarray(probs), {k: jnp.asarray(v) for k, v in
                                                       tensors.items()})
    np.testing.assert_array_equal(got.reshape(probs.shape).numpy(), np.asarray(want))
    assert not np.array_equal(np.asarray(want)[:, 2], probs[:, 2])


def _jax_scan(jed, arr, i, t_limit, reverse, p2p=False, pair=None, pair_lo=None):
    """Image i's coupled pass through the JAX editor's own program, called
    as the editor calls it (guidance 3)."""
    ctx = jnp.asarray(arr["ctx"][i])
    g = jnp.asarray(3.0, jnp.float32)
    pair = jnp.asarray(arr["pair"][i][:, None]) if pair is None else pair
    args = (jed._unet_f32(), pair, ctx, g)
    if p2p:
        tensors = {k: jnp.asarray(v[i]) for k, v in _tensors(2, False).items()}
        fn = jed._coupled(t_limit, reverse, MW, use_p2p=True)
        return fn(*args, tensors, jnp.asarray(arr["edit"][i]), pair_lo=pair_lo)
    fn = jed._coupled(t_limit, reverse, MW)
    return fn(*args) if reverse else fn(*args, pair_lo=pair_lo)


@pytest.mark.parametrize("mode", ["reverse", "forward", "p2p"])
def test_coupled_scan_f32_matches_jax(setup, mode):
    """One f32 coupled pass from step 1 for 2 images at once against the JAX
    editor's program per image: inversion, generation, and generation under
    the takeover (3 rows per image, each with its own tensors)."""
    _, tpipe, jeds, arr = setup
    reverse, p2p = mode == "reverse", mode == "p2p"
    kw = {}
    if p2p:
        kw = dict(control=tep.EdictP2PControl(STEPS), edit_context=_t(arr["edit"]),
                  tensors={k: _t(v) for k, v in _tensors(2, False).items()})
    with torch.inference_mode():
        got = coupled_scan(tpipe.unet, EDICTEditor(tpipe).schedule, _t(arr["pair"]),
                           _t(arr["ctx"]), 3.0, T_LIMIT, reverse, **kw)
    assert got.shape == (2, 2, 8, 8, 4) and got.dtype == torch.float32
    for i in range(2):
        want = _jax_scan(jeds["f32"], arr, i, T_LIMIT, reverse, p2p)
        assert rel_err(got[i], np.asarray(want)[:, 0]) <= RTOL
    assert rel_err(got, arr["pair"]) > 1e-2


def test_coupled_scan_df64_matches_jax(setup):
    """The float64 carry's full inversion and regeneration for 2 images
    against the JAX double-float pair (hi + lo), within the UNet's f32
    noise."""
    _, tpipe, jeds, arr = setup
    sched = EDICTEditor(tpipe).schedule
    with torch.inference_mode():
        inv = coupled_scan(tpipe.unet, sched, _t(arr["pair"]), _t(arr["ctx"]), 3.0, 0, True,
                           precision="df64")
        rec = coupled_scan(tpipe.unet, sched, inv, _t(arr["ctx"]), 3.0, 0, False,
                           precision="df64")
    assert inv.dtype == rec.dtype == torch.float64
    for i in range(2):
        hi, lo = _jax_scan(jeds["df64"], arr, i, 0, True)
        want = np.float64(np.asarray(hi)) + np.asarray(lo)
        assert rel_err(inv[i], want[:, 0]) <= RTOL
        rhi, rlo = _jax_scan(jeds["df64"], arr, i, 0, False, pair=hi, pair_lo=lo)
        assert rel_err(rec[i], (np.float64(np.asarray(rhi)) + np.asarray(rlo))[:, 0]) <= RTOL


def test_roundtrip_df64_beats_f32(setup):
    """The JAX package's own criterion (tests/test_edict.py): a strength-1.0
    round trip at 8 steps rebuilds the pair with MSE below 1e-12 in float64
    and at least 10x below the f32 round trip's, and the inversion moves the
    pair."""
    _, tpipe, _, arr = setup
    sched = make_ddim_schedule(8)
    pair = _t(arr["pair"][:1]) * 0.6
    ctx = _t(arr["ctx"][:1])

    def round_trip(precision):
        with torch.inference_mode():
            inv = coupled_scan(tpipe.unet, sched, pair, ctx, 3.0, 0, True,
                               precision=precision)
            return inv, coupled_scan(tpipe.unet, sched, inv, ctx, 3.0, 0, False,
                                     precision=precision)

    _, rec32 = round_trip("f32")
    inv64, rec64 = round_trip("df64")
    mse32 = ((rec32.double() - pair.double()) ** 2).mean().item()
    mse64 = ((rec64 - pair.double()) ** 2).mean().item()
    assert mse64 < 1e-12 and mse64 < mse32 / 10, (mse32, mse64)
    assert (inv64 - pair).abs().max().item() > 1e-3


@pytest.mark.parametrize("method", METHODS)
def test_editor_strip(setup, method):
    """Both methods' strips (f32 carry; the float64 carry's passes are held
    to JAX's above). The f32 round trip misses its input by ~1e-5 of max
    (the f32 carry's own error, which float64 removes), ten times the other
    loops' f32 noise, and the two packages' reconstructions differ by as
    much: their decoded panels may flip by 1 level on up to 5% of the values
    (4.2% measured), where the other editors' tests allow 1e-3."""
    jpipe, tpipe, jeds, _ = setup
    img = seeded_images(119, 1)[0]
    got = EDICTEditor(tpipe)(method, img, *PROMPTS[0])
    assert_strips_match(got, np.asarray(jeds["f32"](method, img, *PROMPTS[0])), flipped=5e-2)
    with pytest.raises(NotImplementedError):
        EDICTEditor(tpipe)("edict+masactrl", img, *PROMPTS[0])


@pytest.mark.parametrize("method,precision", [("edict+direct_forward", "f32"),
                                              ("edict+p2p", "df64")])
def test_batched_matches_single_editor(setup, method, precision):
    """Two images with their own prompt pairs through one batched edit ==
    each through the single-image editor (recon and edit panels)."""
    _, tpipe, _, _ = setup
    size = tpipe.config.image_size
    imgs = seeded_images(120, 2)
    src, tar = (torch.stack([tpipe.encode_prompt([p[j]]) for p in PROMPTS]) for j in (0, 1))
    tensors = stack_tensors([tep.make_edict_p2p_tensors(*p, tpipe.tokenizer) for p in PROMPTS])
    recon, edit = BatchedEDICT(tpipe, precision).edit_batch(method, imgs, src, tar, tensors)
    for i, p in enumerate(PROMPTS):
        want = EDICTEditor(tpipe, precision)(method, imgs[i], *p)[:, 2 * size:]
        assert_panels_close(np.concatenate([recon[i], edit[i]], axis=1), want)
    assert set(BatchedEDICT.METHODS) == set(METHODS)
    with pytest.raises(NotImplementedError):
        BatchedEDICT(tpipe).edit_batch("edict+masactrl", imgs, src, tar)
