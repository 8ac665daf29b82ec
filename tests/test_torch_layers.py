"""Layers of the PyTorch port vs ``pnpinversion_tpu/models/layers.py``, f32
on the CPU. The port computes on NCHW tensors, the JAX package on NHWC: the
tests transpose."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_parity  # noqa: F401  (caps torch's CPU threads)
from pnpinversion_tpu.models import layers as jl
from pnpinversion_tpu_torch.models import layers as tl

# f32 on both sides, same formulas; only the summation order differs
ATOL = 1e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def test_linear(rng):
    x = rng.randn(2, 7, 16).astype(np.float32)
    w = (rng.randn(16, 24) / 4).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    want = jl.linear({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x))
    got = F.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("k,stride,size", [(3, 1, 8), (1, 1, 8), (3, 2, 8), (3, 2, 7)])
def test_conv2d_same(rng, k, stride, size):
    """Includes the stride-2 "SAME" conv of the UNet downsamplers, which pads
    (0 before, 1 after) as XLA does."""
    x = rng.randn(2, size, size, 6).astype(np.float32)
    w = (rng.randn(k, k, 6, 5) / 4).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    want = jl.conv2d({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x),
                     stride=stride)
    w_oihw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = tl.conv2d(_nchw(x), w_oihw, torch.from_numpy(b), stride=stride)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)
    if (k, stride, size) == (3, 2, 8):
        # torch's symmetric padding=1 is a different function here
        sym = F.conv2d(_nchw(x), w_oihw, torch.from_numpy(b), stride=2, padding=1)
        assert np.abs(_nhwc(sym) - np.asarray(want)).max() > 1e-2


def test_conv2d_valid_after_pad(rng):
    """The VAE encoder's downsample: explicit (0, 1) pad, then VALID."""
    x = rng.randn(1, 8, 8, 4).astype(np.float32)
    w = (rng.randn(3, 3, 4, 4) / 4).astype(np.float32)
    want = jl.conv2d({"kernel": jnp.asarray(w)},
                     jnp.pad(jnp.asarray(x), ((0, 0), (0, 1), (0, 1), (0, 0))),
                     stride=2, padding="VALID")
    got = tl.conv2d(F.pad(_nchw(x), (0, 1, 0, 1)),
                    torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
                    stride=2, padding="VALID")
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("eps,channels_last", [(1e-5, False), (1e-6, True)])
def test_group_norm(rng, eps, channels_last):
    x = (rng.randn(2, 4, 4, 16) * 3 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    want = jl.group_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                         jnp.asarray(x), 4, eps=eps)
    xt = _nchw(x)
    if channels_last:
        xt = xt.to(memory_format=torch.channels_last)
    got = tl.group_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias), 4, eps=eps)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)


def test_layer_norm(rng):
    x = (rng.randn(2, 5, 32) * 2 + 3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    bias = rng.randn(32).astype(np.float32)
    want = jl.layer_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                         jnp.asarray(x))
    got = tl.layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_layer_norm_bf16_one_pass(rng):
    """bf16 inputs take one-pass moments (E[x^2] - E[x]^2) in f32, as in the
    JAX package; both sides round the result to bf16 (2^-8 relative)."""
    x = (rng.randn(3, 64) * 2 + 1).astype(np.float32)
    ones, zeros = np.ones(64, np.float32), np.zeros(64, np.float32)
    want = jl.layer_norm({"scale": jnp.asarray(ones), "bias": jnp.asarray(zeros)},
                         jnp.asarray(x, jnp.bfloat16))
    got = tl.layer_norm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(ones),
                        torch.from_numpy(zeros))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2)


def test_activations(rng):
    x = rng.randn(4, 33).astype(np.float32) * 4
    np.testing.assert_allclose(tl.silu(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.silu(jnp.asarray(x))), atol=ATOL)
    np.testing.assert_allclose(tl.quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.quick_gelu(jnp.asarray(x))), atol=ATOL)
    # the UNet's GEGLU uses exact (erf) GELU
    np.testing.assert_allclose(F.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False)),
                               atol=ATOL)


@pytest.mark.parametrize("dim", [32, 320])
def test_timestep_embedding(dim):
    t = np.array([0, 1, 481, 999], np.float32)
    want = jl.timestep_embedding(jnp.asarray(t), dim)
    got = tl.timestep_embedding(torch.from_numpy(t), dim)
    # sin/cos of arguments up to ~1000: a few f32 ulps of the argument
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_nearest_upsample(rng):
    x = rng.randn(2, 3, 5, 4).astype(np.float32)
    want = jl.nearest_upsample_2x(jnp.asarray(x))
    np.testing.assert_array_equal(_nhwc(tl.nearest_upsample_2x(_nchw(x))), np.asarray(want))
