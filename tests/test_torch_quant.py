"""The port's weight-only int8 UNet (``ops/quant.py``, ``--quant w8``) against
the JAX package's (``pnpinversion_tpu/ops/quant.py``) at TINY, f32 on the
CPU, with the same numpy weights: the int8 weights and scales bit for bit,
the layers' outputs, the w8 UNet's eps (and its input gradient), and the
mode's switches (``PNPI_QUANT``, the ``ValueError``). The w8 edits against
JAX's are ``tests/test_torch_quant_edits.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import numpy_params, rel_err, tiny_configs
from pnpinversion_tpu.configs import TINY as JTINY
from pnpinversion_tpu.models import layers as jlayers
from pnpinversion_tpu.models.unet import init_unet_params, unet_apply
from pnpinversion_tpu.ops import quant as jquant
from pnpinversion_tpu_torch.configs import TINY
from pnpinversion_tpu_torch.convert import from_jax_params
from pnpinversion_tpu_torch.convert.from_jax import unet_state_dict
from pnpinversion_tpu_torch.models.layers import Conv2d, Linear
from pnpinversion_tpu_torch.ops import quant
from pnpinversion_tpu_torch.pipeline import SDPipeline

# f32 on both sides, relative to max |JAX's|: summation-order noise
LAYER_RTOL = 1e-6
UNET_RTOL = 1e-5
FLOAT_REL_L2 = 0.02  # JAX's own bound on w8 eps against the float eps (tests/test_quant.py)


# JAX's function jitted, as its SDPipeline.create runs it: XLA turns the
# division by 127 into a product with its reciprocal, whose scales the port
# reproduces (the eager function's differ by an ulp in some channels)
jax_quantize = jax.jit(jquant.quantize_unet_dots, static_argnames="convs")


@pytest.fixture(scope="module")
def unet_params():
    return numpy_params(init_unet_params, JTINY.unet, seed=3)


@pytest.fixture(scope="module")
def jax_w8(unet_params):
    """{convs: JAX's quantize_unet_dots tree, numpy leaves}."""
    params = jax.tree.map(jnp.asarray, unet_params)
    return {convs: jax.tree.map(np.array, jax_quantize(params, convs=convs))
            for convs in (False, True)}


@pytest.mark.parametrize("convs", [False, True])
def test_int8_weights_are_jax_bit_for_bit(unet_params, jax_w8, convs):
    """Quantizing in the port gives JAX's int8 weights and f32 scales, on the
    same layers (JAX's tree in the port's names); and JAX's w8 tree loads
    into the port (``from_jax_params``) as the same module."""
    want = unet_state_dict(jax_w8[convs])
    unet = quant.quantize_unet_dots(from_jax_params(unet_params, TINY.unet), convs=convs)
    got = unet.state_dict()
    assert sorted(got) == sorted(want)
    n_int8 = 0
    for k, v in got.items():
        w = np.asarray(want[k])
        assert v.dtype == (torch.int8 if w.dtype == np.int8 else torch.float32), k
        np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
        n_int8 += v.dtype == torch.int8
    quantized = {n for n, m in unet.named_modules() if isinstance(m, (quant.QLinear,
                                                                      quant.QConv2d))}
    assert n_int8 == len(quantized)
    assert {"conv_in", "conv_out"} <= quantized if convs else not {"conv_in"} & quantized
    assert "time_embedding.linear_1" not in quantized
    loaded = from_jax_params(jax_w8[convs], TINY.unet)
    assert quant.is_quantized(loaded)
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, got[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("case", ["linear", "conv1x1", "conv3x3", "conv3x3_stride2"])
def test_layers_match_jax(case):
    """qlinear, the 1x1 conv (the linear layout) and the kxk conv: the port's
    w8 layer against the JAX dispatch on the same float weights."""
    rng = np.random.RandomState(5)
    if case == "linear":
        w, b = rng.randn(24, 40).astype(np.float32) * 0.1, rng.randn(40).astype(np.float32)
        x = rng.randn(2, 7, 24).astype(np.float32)
        jp = jquant.quantize_linear_params({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)})
        want = jlayers.linear(jp, jnp.asarray(x))
        layer = Linear(24, 40)
        layer.weight.data, layer.bias.data = torch.from_numpy(w.T.copy()), torch.from_numpy(b)
        got = quant.QLinear.from_float(layer)(torch.from_numpy(x))
    else:
        k, stride = (1, 1) if case == "conv1x1" else (3, 2 if case.endswith("2") else 1)
        w = rng.randn(k, k, 16, 24).astype(np.float32) * 0.1
        b = rng.randn(24).astype(np.float32)
        x = rng.randn(2, 9, 9, 16).astype(np.float32)
        jp = jquant.quantize_conv_params({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)})
        assert jp["kernel_w8"].ndim == (2 if k == 1 else 4)
        want = jlayers.conv2d(jp, jnp.asarray(x), stride=stride)
        layer = Conv2d(16, 24, k, stride=stride)
        layer.weight.data = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
        layer.bias.data = torch.from_numpy(b)
        q = quant.QConv2d.from_float(layer)
        assert q.weight.dim() == (2 if k == 1 else 4) and q.weight.dtype == torch.int8
        got = q(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert rel_err(got, want) <= LAYER_RTOL


@pytest.mark.parametrize("convs", [False, True])
def test_w8_unet_eps_matches_jax(unet_params, jax_w8, convs):
    """The TINY w8 UNet's eps within UNET_RTOL of JAX's w8 eps, and within
    JAX's own bound of the float eps; input gradients flow."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    apply = jax.jit(lambda p, x, c: unet_apply(p, x, jnp.asarray(11), c, JTINY.unet)[0])
    want = apply(jax.tree.map(jnp.asarray, jax_w8[convs]), x, ctx)
    unet = quant.quantize_unet_dots(from_jax_params(unet_params, TINY.unet), convs=convs)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = unet(xt, 11, torch.from_numpy(ctx))[0]
    assert rel_err(got, want) <= UNET_RTOL
    with torch.inference_mode():
        ref = from_jax_params(unet_params, TINY.unet)(torch.from_numpy(x), 11,
                                                       torch.from_numpy(ctx))[0]
    assert float((got.detach() - ref).norm() / ref.norm()) < FLOAT_REL_L2
    got.pow(2).sum().backward()
    assert xt.grad is not None and bool(torch.isfinite(xt.grad).all())


def test_quant_mode_switches(monkeypatch):
    """``quantize=None`` reads PNPI_QUANT (as the JAX ``create`` does),
    "none" overrides it, and any other mode raises ``ValueError``; the w8
    weights are quantized after the cast and keep f32 scales."""
    cfg = tiny_configs()[1]
    monkeypatch.setenv("PNPI_QUANT", "w8")
    pipe = SDPipeline.create(cfg, device="cpu", num_ddim_steps=2, dtype=torch.bfloat16)
    assert quant.is_quantized(pipe.unet) and not quant.is_quantized(pipe.vae)
    q = pipe.unet.mid_block.attentions[0].transformer_blocks[0].attn1.to_q
    assert q.weight.dtype == torch.int8 and q.weight_scale.dtype == torch.float32
    pipe.unet.to(torch.float32)
    assert q.weight.dtype == torch.int8 and q.weight_scale.dtype == torch.float32
    assert not quant.is_quantized(SDPipeline.create(cfg, device="cpu", quantize="none").unet)
    with pytest.raises(ValueError, match="already quantized"):
        quant.quantize_unet_dots(pipe.unet)
    with pytest.raises(ValueError, match="int8"):
        SDPipeline.create(cfg, device="cpu", quantize="int8")
    monkeypatch.setenv("PNPI_QUANT", "w4")
    with pytest.raises(ValueError, match="w4"):
        SDPipeline.create(cfg, device="cpu")
    monkeypatch.delenv("PNPI_QUANT")
    assert not quant.is_quantized(SDPipeline.create(cfg, device="cpu").unet)
