"""Flash-attention forward of the PyTorch port vs the JAX package's Pallas
kernel (interpret mode on the CPU), and the wrapper's dispatch rules."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (caps torch's CPU threads)
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
