"""The evaluator's closed-form metrics, resize, LPIPS and ViTs of the PyTorch
port against the JAX package, f32 on the CPU, with the same numpy weights and
inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import numpy_params, rel_err
from pnpinversion_tpu.evaluation import metrics as jm
from pnpinversion_tpu.models import lpips as jlpips
from pnpinversion_tpu.models import vit as jvit
from pnpinversion_tpu_torch.convert import _load, from_jax_params, lpips_state_dict
from pnpinversion_tpu_torch.evaluation import metrics as tm
from pnpinversion_tpu_torch.models import lpips as tlpips
from pnpinversion_tpu_torch.models import vit as tvit

# resize: per-axis weights computed as JAX computes them, two f32 products
# against JAX's one einsum: a few f32 ulps of values in [0, 1]
RESIZE_ATOL = 1e-5
# mse/psnr/ssim: the same f32 formulas, sums in another order
METRIC_RTOL = 1e-5
# LPIPS: 13 convolutions deep, f32 on both sides
LPIPS_RTOL = 1e-4
# the ViTs: f32 through two layers, relative to max |reference|
VIT_RTOL = 1e-4
TINY_DINO = dict(image_size=32, patch_size=8, width=24, layers=2, heads=2, style="dino",
                 activation="gelu")


@pytest.mark.parametrize("shape,out,method", [
    ((512, 512, 3), (224, 224), "bicubic"),
    ((512, 512, 3), (224, 224), "bilinear"),
    ((512, 768, 3), (224, 336), "bicubic"),  # the long side of a non-square crop
    ((4, 4, 5), (6, 6), "bicubic"),  # an upsample, as the position table takes
    ((4, 4, 5), (6, 6), "bilinear"),
])
def test_resize_matches_jax(shape, out, method):
    x = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out + shape[2:], method=method))
    got = tm.resize(torch.from_numpy(x), out, method).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(512, 768, 3), (600, 512, 3)])
def test_center_crop_resize_224_matches_jax(shape):
    x = np.random.RandomState(shape[0]).rand(*shape).astype(np.float32)
    want = np.asarray(jm.center_crop_resize_224(jnp.asarray(x)))
    got = tm.center_crop_resize_224(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["mse", "psnr", "ssim"])
def test_closed_form_metrics_match_jax(name):
    rng = np.random.RandomState(7)
    a = rng.rand(96, 80, 3).astype(np.float32)
    b = np.clip(a + rng.randn(96, 80, 3).astype(np.float32) * 0.05, 0, 1)
    want = float(getattr(jm, name)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(tm, name)(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) <= METRIC_RTOL * abs(want)


def test_normalizers_match_jax():
    x = np.random.RandomState(8).rand(5, 7, 3).astype(np.float32) * 255
    np.testing.assert_allclose(tm.clip_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.clip_normalize(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(tm.imagenet_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.imagenet_normalize(jnp.asarray(x))), rtol=1e-6)


@pytest.fixture(scope="module")
def lpips_pair():
    params = numpy_params(lambda key, _: jlpips.init_lpips_params(key), None, seed=4)
    with torch.device("meta"):
        module = tlpips.LPIPS()
    return jax.tree.map(jnp.asarray, params), _load(module, lpips_state_dict(params))


def test_lpips_matches_jax(lpips_pair):
    jparams, module = lpips_pair
    rng = np.random.RandomState(9)
    a, b = (rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32) for _ in range(2))
    want = float(jax.jit(jlpips.lpips)(jparams, jnp.asarray(a), jnp.asarray(b)))
    with torch.inference_mode():
        got = float(module(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) <= LPIPS_RTOL * abs(want)


@pytest.mark.parametrize("size", [255, 127, 111, 64])
def test_maxpool_ceil_matches_jax(size):
    """The odd sizes the 512^2 (255, 127) and 224^2 (111) inputs reach."""
    x = np.random.RandomState(size).randn(1, size, size, 4).astype(np.float32)
    want = np.asarray(jlpips._maxpool_ceil(jnp.asarray(x)))
    got = tlpips.maxpool_ceil(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_lpips_taps_match_jax(lpips_pair):
    jparams, module = lpips_pair
    x = np.random.RandomState(10).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    want = jlpips.squeeze_features(jparams, jnp.asarray(x))
    with torch.inference_mode():
        got = module.features(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(g.shape) for g in got] == [(1, w.shape[3], w.shape[1], w.shape[2])
                                             for w in want]
    for g, w in zip(got, want):
        assert rel_err(g.permute(0, 2, 3, 1), w) <= LPIPS_RTOL


@pytest.mark.parametrize("cfg_kw,image_size", [
    ({}, 32),                                   # TINY_VIT (CLIP style)
    (TINY_DINO, 32),                            # the tiny calculator's DINO
    (TINY_DINO, 48),                            # another size: the position table is resized
])
def test_vit_matches_jax(cfg_kw, image_size):
    jcfg = jvit.ViTConfig(**cfg_kw) if cfg_kw else jvit.TINY_VIT
    tcfg = tvit.ViTConfig(**cfg_kw) if cfg_kw else tvit.TINY_VIT
    params = numpy_params(jvit.init_vit_params, jcfg, seed=5)
    module = from_jax_params(params, tcfg)
    x = np.random.RandomState(11).randn(2, image_size, image_size, 3).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    pooled, qkvs = jvit.vit_apply(jparams, jnp.asarray(x), jcfg, return_qkv=True)
    tokens, _ = jvit.vit_apply(jparams, jnp.asarray(x), jcfg, return_tokens=True)
    with torch.inference_mode():
        got, got_qkvs = module(torch.from_numpy(x), return_qkv=True)
        got_tokens, _ = module(torch.from_numpy(x), return_tokens=True)
    assert rel_err(got, pooled) <= VIT_RTOL
    assert rel_err(got_tokens, tokens) <= VIT_RTOL
    assert len(got_qkvs) == len(qkvs) == jcfg.layers
    for g, w in zip(got_qkvs, qkvs):
        assert rel_err(g, w) <= VIT_RTOL


def test_structure_distance_matches_jax():
    jcfg, tcfg = jvit.ViTConfig(**TINY_DINO), tvit.ViTConfig(**TINY_DINO)
    params = numpy_params(jvit.init_vit_params, jcfg, seed=6)
    module = from_jax_params(params, tcfg)
    rng = np.random.RandomState(12)
    a = rng.randn(1, 32, 32, 3).astype(np.float32)
    b = a + 0.3 * rng.randn(1, 32, 32, 3).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    want_sim = jvit.dino_keys_self_sim(jparams, jnp.asarray(a), jcfg, layer=1)
    want = float(jvit.structure_distance(jparams, jnp.asarray(a), jnp.asarray(b), jcfg, layer=1))
    with torch.inference_mode():
        got_sim = tvit.dino_keys_self_sim(module, torch.from_numpy(a), layer=1)
        got = float(tvit.structure_distance(module, torch.from_numpy(a), torch.from_numpy(b),
                                            layer=1))
    assert rel_err(got_sim, want_sim) <= VIT_RTOL
    assert abs(got - want) <= VIT_RTOL * abs(want)
