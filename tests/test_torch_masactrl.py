"""MasaCtrl in the PyTorch port vs the JAX package: the three controls' hooks
on the same seeded q/k/v and cross maps at N = 1 and N = 2 images (the JAX
side under ``jax.vmap``), the mask resizes against ``jax.image.resize`` at
SD1.4's sizes, both editors' strips at TINY with 3 DDIM steps (f32 on the
CPU), and ``BatchedMasaCtrl`` against the port's single-image editor."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    assert_panels_close,
    assert_strips_match,
    jax_torch_pipelines,
    seeded_images,
)
from pnpinversion_tpu.control import masactrl as jmc
from pnpinversion_tpu.control.base import AttnSite as JaxSite
from pnpinversion_tpu.editors.masactrl_editor import MasaCtrlEditor as JaxMasaCtrlEditor
from pnpinversion_tpu_torch.control import masactrl as tmc
from pnpinversion_tpu_torch.control.base import AttnSite
from pnpinversion_tpu_torch.editors.masactrl_editor import METHODS, MasaCtrlEditor
from pnpinversion_tpu_torch.parallel.sweep import BatchedMasaCtrl

torch.set_num_threads(2)

H, RES, D = 2, 4, 8
S = RES * RES
SCALE = D ** -0.5
STEPS = 3
G = 7.5
# a MasaCtrl that acts at TINY (7 transformer blocks, 3 steps): from block 3
# (the decoder's) and from step 1
START = dict(step=1, layper=3)
# f32 on both sides: the attention outputs differ by summation order only
RTOL = 1e-5
PROMPTS = [("a cat on a mat", "a dog on a mat"), ("a red car", "a blue car")]
SITE = dict(index=12, place="up", resolution=RES, is_cross=False, heads=H)


def _qkv(seed, n):
    """q, k, v: (n, 4, H, S, D) f32, one image's 4 rows [uncond src, uncond
    tgt, cond src, cond tgt] per image."""
    rng = np.random.RandomState(seed)
    return [rng.randn(n, 4, H, S, D).astype(np.float32) for _ in range(3)]


def _rows(x):
    return torch.from_numpy(x.reshape((-1,) + x.shape[2:]))


def _images(x, n):
    return x.reshape((n, 4) + x.shape[1:]).numpy()


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("union", [False, True])
@pytest.mark.parametrize("step", [1, 4])
def test_qkv_hook_matches_jax_vmap(n, union, step):
    """Each half's K/V replaced by its own image's source row's (concatenated
    to the own K/V with ``union``) from the start step on: bit for bit."""
    spec = dict(start_step=4, start_layer=10, union=union)
    q, k, v = _qkv(10 * n + step, n)
    jctrl = jmc.MasaCtrlControl(jmc.MasaCtrlSpec(**spec))
    want = jax.vmap(lambda a, b, c: jctrl.qkv_hook(JaxSite(**SITE), a, b, c, {}, {},
                                                   jnp.int32(step)))(q, k, v)
    got = tmc.MasaCtrlControl(tmc.MasaCtrlSpec(**spec)).qkv_hook(
        AttnSite(**SITE), _rows(q), _rows(k), _rows(v), {}, {}, step)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_images(g, n), np.asarray(w))
    if step >= 4 and n == 2:  # each image takes its own source row
        kk = _images(got[1], n)[..., :S, :]
        np.testing.assert_array_equal(kk[:, 1], k[:, 0])
        np.testing.assert_array_equal(kk[:, 3], k[:, 2])
        assert not np.array_equal(kk[0], kk[1])


def test_qkv_hook_below_start_layer_and_at_cross():
    q, k, v = (_rows(x) for x in _qkv(3, 2))
    ctrl = tmc.MasaCtrlControl(tmc.MasaCtrlSpec(start_step=0, start_layer=10))
    for site in (AttnSite(**dict(SITE, index=9)), AttnSite(**dict(SITE, is_cross=True))):
        got = ctrl.qkv_hook(site, q, k, v, {}, {}, 5)
        assert all(a is b for a, b in zip(got, (q, k, v)))


def _masks(seed, n, size):
    """Per image: source and target masks (size, size) in {0, 1}, each with
    foreground and background."""
    rng = np.random.RandomState(seed)
    m = (rng.rand(2, n, size, size) > 0.5).astype(np.float32)
    assert 0 < m.mean() < 1
    return m


@pytest.mark.parametrize("n", [1, 2])
def test_masked_fg_bg_attention(n):
    """Keys split into foreground and background, queries blended by their
    own mask; masks with both kinds of keys and queries."""
    q, k, v = (x[:, 0] for x in _qkv(5, n))
    km, qm = (m.reshape(n, S) for m in _masks(6, n, RES))
    want = jax.vmap(lambda a, b, c, d, e: jmc._masked_fg_bg_attention(a, b, c, SCALE, d, e))(
        q, k, v, km, qm)
    q, k, v, km, qm = (torch.from_numpy(x) for x in (q, k, v, km, qm))
    got = tmc._masked_fg_bg_attention(q, k, v, SCALE, km, qm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=RTOL)


# (mask size, site resolution, mode): SD1.4's mask sizes onto its sites
RESIZES = [(16, 32, "nearest"), (16, 64, "nearest"), (64, 32, "nearest"),
           (16, 32, "bilinear"), (16, 64, "bilinear")]


@pytest.mark.parametrize("size,res,mode", RESIZES)
def test_resize_matches_jax_image_resize(size, res, mode):
    """"nearest" samples at half-pixel centres in JAX (torch's
    "nearest-exact"); bilinear up-sampling agrees to f32 rounding."""
    rng = np.random.RandomState(size + res)
    x = rng.rand(2, size, size).astype(np.float32)
    if mode == "nearest":
        x = (x > 0.5).astype(np.float32)
    want = np.stack([np.asarray(jax.image.resize(jnp.asarray(m), (res, res), mode)).reshape(-1)
                     for m in x])
    got = tmc.resize_maps(torch.from_numpy(x), res, mode).numpy()
    if mode == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("step", [0, 2])
def test_mask_control_matches_jax_vmap(n, step):
    """``MasaCtrlMaskControl``: 8^2 masks resized to the 4^2 site, before and
    after the start step."""
    q, k, v = _qkv(7 + n, n)
    mask_s, mask_t = _masks(8, n, 8)
    spec = dict(start_step=1, start_layer=3)
    jctrl = jmc.MasaCtrlMaskControl(jmc.MasaCtrlSpec(**spec))
    want = jax.vmap(lambda a, b, c, ms, mt: jctrl.attention_override(
        JaxSite(**SITE), a, b, c, SCALE, {"mask_s": ms, "mask_t": mt}, {},
        jnp.int32(step))[0])(q, k, v, mask_s, mask_t)
    got, _ = tmc.MasaCtrlMaskControl(tmc.MasaCtrlSpec(**spec)).attention_override(
        AttnSite(**SITE), _rows(q), _rows(k), _rows(v), SCALE,
        {"mask_s": torch.from_numpy(mask_s), "mask_t": torch.from_numpy(mask_t)}, {}, step)
    np.testing.assert_allclose(_images(got, n), np.asarray(want), rtol=0, atol=RTOL)


def _cross_maps(seed, n, agg):
    """Per image: the step's summed cross maps (4, agg^2, 77) and one-hot
    selectors (77,) for the reference and current tokens."""
    rng = np.random.RandomState(seed)
    sums = rng.rand(n, 4, agg * agg, 77).astype(np.float32)
    sel = np.zeros((2, n, 77), np.float32)
    sel[0, :, 2] = sel[1, :, 3] = 1.0
    return sums, sel


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("count", [0.0, 3.0])
def test_mask_auto_control_matches_jax_vmap(n, count):
    """``MasaCtrlMaskAutoControl``: masks from 2^2 maps, bilinear up to the
    4^2 site, thresholded at 0.5 (both kinds of key); with no maps this step
    the target attends to the source K/V without masks."""
    q, k, v = _qkv(9 + n, n)
    agg, thres = 2, 0.5
    sums, sel = _cross_maps(11, n, agg)
    spec = jmc.MasaCtrlSpec(start_step=0, start_layer=3)
    jctrl = jmc.MasaCtrlMaskAutoControl(spec, thres=thres, agg_res=agg)

    def one(a, b, c, sm, ref, cur):
        state = {"mc_cross_sum": sm, "mc_cross_cnt": jnp.asarray(count)}
        return jctrl.attention_override(JaxSite(**SITE), a, b, c, SCALE,
                                        {"ref_token_mask": ref, "cur_token_mask": cur},
                                        state, jnp.int32(1))[0]

    want = jax.vmap(one)(q, k, v, sums, sel[0], sel[1])
    tctrl = tmc.MasaCtrlMaskAutoControl(tmc.MasaCtrlSpec(start_step=0, start_layer=3),
                                        thres=thres, agg_res=agg)
    state = {"mc_cross_sum": torch.from_numpy(sums.reshape(n * 4, agg * agg, 77)),
             "mc_cross_cnt": count}
    tensors = {"ref_token_mask": torch.from_numpy(sel[0]),
               "cur_token_mask": torch.from_numpy(sel[1])}
    got, _ = tctrl.attention_override(AttnSite(**SITE), _rows(q), _rows(k), _rows(v), SCALE,
                                      tensors, state, 1)
    np.testing.assert_allclose(_images(got, n), np.asarray(want), rtol=0, atol=RTOL)
    if count:
        masks = tctrl._agg_mask(state, tensors["ref_token_mask"], 2, RES) >= thres
        assert 0 < masks.float().mean() < 1


def test_mask_auto_state_matches_jax():
    """The store: probs_hook adds each row's head-mean map at the agg_res
    cross sites only, the step callback empties it."""
    n, agg = 2, 2
    probs = np.random.RandomState(12).rand(n, 4, H, agg * agg, 77).astype(np.float32)
    site = dict(index=4, place="up", resolution=agg, is_cross=True, heads=H)
    spec = jmc.MasaCtrlSpec()
    jctrl = jmc.MasaCtrlMaskAutoControl(spec, agg_res=agg)
    tctrl = tmc.MasaCtrlMaskAutoControl(tmc.MasaCtrlSpec(), agg_res=agg)
    assert tctrl.needs_probs(AttnSite(**site)) and jctrl.needs_probs(JaxSite(**site))
    assert not tctrl.needs_probs(AttnSite(**dict(site, resolution=4)))

    def one(p):
        state = jctrl.init_state(2, heads=H)
        for _ in range(2):
            _, state = jctrl.probs_hook(JaxSite(**site), p, {}, state, 0)
        return state["mc_cross_sum"], state["mc_cross_cnt"]

    want_sum, want_cnt = jax.vmap(one)(probs)
    state = tctrl.init_state(2, heads=H, images=n)
    rows = torch.from_numpy(probs.reshape((n * 4,) + probs.shape[2:]))
    for _ in range(2):
        _, state = tctrl.probs_hook(AttnSite(**site), rows, {}, state, 0)
    np.testing.assert_allclose(_images(state["mc_cross_sum"], n), np.asarray(want_sum),
                               rtol=0, atol=1e-6)
    assert state["mc_cross_cnt"] == float(want_cnt[0]) == 2.0
    _, state = tctrl.step_callback(None, {}, state, 0)
    assert state["mc_cross_cnt"] == 0.0 and not state["mc_cross_sum"].any()


@pytest.fixture(scope="module")
def editors():
    jpipe, tpipe = jax_torch_pipelines(seed=81, steps=STEPS)
    return JaxMasaCtrlEditor(jpipe), MasaCtrlEditor(tpipe)


@pytest.mark.parametrize("method", METHODS)
def test_editor_strip(editors, method):
    """Both editors end to end with a control that acts at TINY; the edit
    panel moves when the control is switched off (start layer 100)."""
    jed, ted = editors
    img = seeded_images(83, 1)[0]
    src, tar = PROMPTS[0]
    got = ted(method, img, src, tar, G, **START)
    assert_strips_match(got, np.asarray(jed(method, img, src, tar, G, **START)))
    off = ted(method, img, src, tar, G, step=1, layper=100)
    assert np.abs(off[:, 48:].astype(int) - got[:, 48:].astype(int)).max() > 2


@pytest.mark.parametrize("use_offsets", [True, False], ids=METHODS[::-1])
def test_batched_matches_single_editor(editors, use_offsets):
    """Two images with their own prompts through one batched edit == each
    through the single-image editor."""
    _, ted = editors
    pipe, size = ted.pipe, ted.pipe.config.image_size
    imgs = seeded_images(85, 2)
    cond = torch.stack([pipe.encode_prompt(["", tar]) for _, tar in PROMPTS])
    sweep = BatchedMasaCtrl(pipe, start_step=START["step"], start_layer=START["layper"])
    recon, edit = sweep.edit_batch(use_offsets, imgs, cond, G)
    method = "directinversion+masactrl" if use_offsets else "ddim+masactrl"
    for i, (src, tar) in enumerate(PROMPTS):
        want = ted(method, imgs[i], src, tar, G, **START)[:, 2 * size:]
        assert_panels_close(np.concatenate([recon[i], edit[i]], axis=1), want)
