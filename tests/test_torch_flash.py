"""Flash attention of the PyTorch port, forward and backward, vs the JAX
package's Pallas kernels (interpret mode on the CPU), and the wrappers'
dispatch rules."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err  # also caps torch's CPU threads
from pnpinversion_tpu.ops.flash_attention import flash_attention as jax_flash
from pnpinversion_tpu_torch.ops import attention as tattn
from pnpinversion_tpu_torch.ops import flash_attention as tflash

# f32 on both sides; the online softmax sums in another order than the
# one-shot softmax, so allow a few f32 ulps of |O| <= ~3
O_ATOL = 2e-5
# |LSE| ~ 6, f32 against a float64 logsumexp: one f32 ulp is 5e-7, but this
# host's CPU reductions were seen to vary run to run by up to 4e-5
LSE_ATOL = 1e-4


@pytest.mark.parametrize("b,h,sq,sk,d", [
    (1, 2, 256, 256, 40),   # SD1.4 64x64-level head dim
    (1, 2, 256, 256, 64),   # SD2.1 head dim
    (1, 2, 256, 128, 40),   # cross-seq Sq != Sk
])
def test_plain_flash_matches_pallas_interpret(b, h, sq, sk, d):
    rng = np.random.RandomState(sq + sk + d)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, h, sk, d).astype(np.float32)
    v = rng.randn(b, h, sk, d).astype(np.float32)
    scale = d ** -0.5
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                block_q=128, block_k=128, interpret=True))
    before = tflash.flash_attention_fwd.launches
    out, lse = tflash.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), scale)
    # CPU tensors take the plain version: no kernel launch is counted
    assert tflash.flash_attention_fwd.launches == before
    np.testing.assert_allclose(out.numpy(), want, atol=O_ATOL)

    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) * scale
    m = s.max(-1, keepdims=True)
    lse_want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    np.testing.assert_allclose(lse.numpy(), lse_want, atol=LSE_ATOL)


def test_use_flash_rule():
    """The JAX package's Pallas shape rule (ops/attention.py:_use_pallas),
    with 'CUDA tensor' in place of 'TPU backend'."""
    q = torch.zeros(1, 8, 4096, 40)
    assert not tattn.use_flash(q, q)  # CPU tensors always take the plain path

    def on_cuda(s):
        return types.SimpleNamespace(is_cuda=True, shape=(3, 8, s, 40))

    # the SD1.4 self-attention sites at 64^2 and 32^2 take the kernel ...
    assert tattn.use_flash(on_cuda(4096), on_cuda(4096))
    assert tattn.use_flash(on_cuda(1024), on_cuda(1024))
    # ... cross-attention (Sk=77), 16^2 and sequences that do not tile do not
    assert not tattn.use_flash(on_cuda(4096), on_cuda(77))
    assert not tattn.use_flash(on_cuda(256), on_cuda(256))
    assert not tattn.use_flash(on_cuda(1000), on_cuda(1000))


# f32 on both sides; the Pallas backward sums over 128-wide blocks and the
# plain one in one product, so allow a few f32 ulps relative to max |grad|
GRAD_RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _jax_flash_vjp(b, h, sq, sk, d):
    """Inputs, dO and jax.vjp of the Pallas kernel (interpret mode)."""
    rng = np.random.RandomState(sq + sk + d + 1)
    q, k, v, do = (rng.randn(b, h, s, d).astype(np.float32) for s in (sq, sk, sk, sq))
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, d ** -0.5, block_q=128, block_k=128,
                                               bwd_block_q=128, bwd_block_k=128,
                                               interpret=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (q, k, v, do), tuple(np.asarray(g) for g in vjp(jnp.asarray(do)))


@pytest.mark.parametrize("path", ["reference", "function"])
@pytest.mark.parametrize("b,h,sq,sk,d", [(1, 2, 256, 256, 40), (1, 2, 256, 256, 64),
                                         (1, 2, 256, 128, 40)])
def test_flash_bwd_matches_pallas_interpret(b, h, sq, sk, d, path):
    """dQ, dK, dV of the plain backward (from the forward's O and LSE) and of
    the FlashAttention autograd Function vs jax.vjp of the Pallas kernels."""
    (q, k, v, do), want = _jax_flash_vjp(b, h, sq, sk, d)
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    scale = d ** -0.5
    before = (tflash.flash_attention_bwd_dq.launches, tflash.flash_attention_bwd_dkv.launches)
    if path == "reference":
        out, lse = tflash.flash_attention_fwd(q, k, v, scale)
        got = tflash.flash_attention_bwd_reference(q, k, v, out, lse, do, scale)
    else:
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        out = tflash.flash_attention(q, k, v, scale)
        assert out.grad_fn is not None
        got = torch.autograd.grad(out, (q, k, v), do)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (tflash.flash_attention_bwd_dq.launches,
            tflash.flash_attention_bwd_dkv.launches) == before
    for g, w in zip(got, want):
        assert rel_err(g, w) <= GRAD_RTOL


def test_flash_attention_gradcheck():
    """FlashAttention's backward against finite differences, in f64."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, s, 8)).requires_grad_(True) for s in (6, 5, 5))
    assert torch.autograd.gradcheck(lambda q, k, v: tflash.flash_attention(q, k, v, 0.35),
                                    (q, k, v))


def test_raw_forward_refuses_grad_tracking_inputs():
    """Only the autograd Function may run the forward on inputs that require
    grad; under no_grad the raw forward takes them."""
    q = torch.zeros(1, 2, 16, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="FlashAttention"):
        tflash.flash_attention_fwd(q, q, q, 0.1)
    with torch.no_grad():
        out, _ = tflash.flash_attention_fwd(q, q, q, 0.1)
    assert out.shape == q.shape


@pytest.mark.parametrize("bh,sq,rows", [
    (8, 1024, 64),    # 1-row 32^2: 128 CTAs of 64 rows fill the card, 64 of 128 rows half of it
    (16, 1024, 128),  # 2-row 32^2: 128 CTAs of 128 rows in one wave, 256 of 64 in two
])
def test_forward_tile_rule(bh, sq, rows):
    """The forward kernel's query tile per CTA, chosen on the host for an
    H100's 132 SMs (a pure function: the kernel itself needs the card)."""
    assert tflash.fwd_tile_rows(bh, sq, 132) == rows
    # the 64^2 sites, 1 to 4 rows, all take 128-row tiles
    assert {tflash.fwd_tile_rows(8 * b, 4096, 132) for b in (1, 2, 3, 4)} == {128}
