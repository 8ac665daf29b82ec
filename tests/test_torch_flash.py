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
    before = [fn.launches for fn in tflash.BWD_WRAPPERS]
    if path == "reference":
        out, lse = tflash.flash_attention_fwd(q, k, v, scale)
        got = tflash.flash_attention_bwd_reference(q, k, v, out, lse, do, scale)
    else:
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        out = tflash.flash_attention(q, k, v, scale)
        assert out.grad_fn is not None
        got = torch.autograd.grad(out, (q, k, v), do)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert [fn.launches for fn in tflash.BWD_WRAPPERS] == before
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


@pytest.mark.parametrize("bh,sk,keys", [
    (8, 4096, 128),   # 1-row 64^2: 256 CTAs of 128 keys in two waves, 512 of 64 in four
    (8, 1024, 64),    # 1-row 32^2: 128 CTAs of 64 keys fill the card, 64 of 128 keys half
    (16, 1024, 128),  # 2-row 32^2: 128 CTAs of 128 keys in one wave, 256 of 64 in two
    (32, 1024, 128),  # 4-row 32^2: 256 CTAs of 128 keys in two waves, 512 of 64 in four
    (16, 4096, 128),  # 2-row 64^2
    (32, 4096, 128),  # 4-row 64^2: 1024 CTAs of 128 keys in eight waves, 2048 of 64 in 16
])
def test_backward_tile_rule(bh, sk, keys):
    """The backward main kernel's keys per CTA, chosen on the host for an
    H100's 132 SMs (a pure function: the kernel itself needs the card)."""
    assert tflash.bwd_tile_keys(bh, sk, 132) == keys


def test_bwd_plain_kernels_compose_to_reference():
    """The plain versions of the prep, main and dQ convert kernels, chained as
    flash_attention_bwd chains the kernels, give the plain backward; stats
    hold LSE * log2(e) and delta with zeros past Sq (a ragged Sq of 70)."""
    rng = np.random.RandomState(5)
    q, do = (torch.from_numpy(rng.randn(1, 2, 70, 16).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(1, 2, 33, 16).astype(np.float32)) for _ in range(2))
    out, lse = tflash.flash_attention_fwd(q, k, v, 0.25)
    stats, dq_acc = tflash.flash_attention_bwd_prep(out, lse, do)
    assert stats.shape == (2, 2, 2, 64) and dq_acc.shape == (2, 128, 16)
    lse2, delta = tflash.bwd_stats_rows(stats, 70)
    np.testing.assert_allclose(lse2.numpy(), lse.reshape(2, 70).numpy() * tflash.LOG2E,
                               rtol=1e-6)
    np.testing.assert_allclose(delta.numpy(), (do * out).sum(-1).reshape(2, 70).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert not stats[:, 1, :, 6:].any()  # rows 70..127 of the last tile
    dk, dv = tflash.flash_attention_bwd_main(q, k, v, do, stats, dq_acc, 0.25)
    assert not dq_acc[:, 70:].any()
    dq = tflash.flash_attention_bwd_dq_convert(dq_acc, q, 0.25)
    for g, w in zip((dq, dk, dv), tflash.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                                       0.25)):
        assert rel_err(g, w) <= GRAD_RTOL


@pytest.mark.parametrize("sq", [1, 64, 65, 200])
def test_bwd_stats_layout(sq):
    """The prep kernel's stats buffer: 64-row tiles of (LSE * log2(e), delta),
    zero past Sq, and the accumulator rounded up to whole tiles."""
    rng = np.random.RandomState(sq)
    out, do = (torch.from_numpy(rng.randn(2, 3, sq, 8).astype(np.float32)) for _ in range(2))
    lse = torch.from_numpy(rng.randn(2, 3, sq).astype(np.float32))
    stats, dq_acc = tflash.flash_attention_bwd_prep_reference(out, lse, do)
    n = -(-sq // 64)
    assert stats.shape == (6, n, 2, 64) and stats.is_contiguous()
    assert dq_acc.shape == (6, 64 * n, 8) and not dq_acc.any()
    rows = stats.permute(0, 2, 1, 3).reshape(6, 2, 64 * n)
    np.testing.assert_allclose(rows[:, 0, :sq].numpy(),
                               (lse * tflash.LOG2E).reshape(6, sq).numpy(), rtol=1e-6)
    np.testing.assert_allclose(rows[:, 1, :sq].numpy(),
                               (do * out).sum(-1).reshape(6, sq).numpy(), rtol=1e-5, atol=1e-6)
    assert not rows[:, :, sq:].any()


@pytest.mark.parametrize("entry,want", [
    ("_ZN12_GLOBAL__N_116flash_bwd_kernelILi2ELi3EEEvN4_GLOBAL__N_14MapsENS_6ParamsE",
     "flash_bwd_kernel<2,3>: 168 registers, stack frame 8 B, spill stores 0 B, loads 0 B, "
     "static smem 0 B"),
    ("_ZN12_GLOBAL__N_121flash_bwd_prep_kernelENS_10PrepParamsE",
     "flash_bwd_prep_kernel: 168 registers, stack frame 8 B, spill stores 0 B, loads 0 B, "
     "static smem 0 B"),
])
def test_ptxas_summary_names_every_kernel(entry, want):
    """chip_smoke's ptxas summary names template instantiations and plain
    kernels alike, and passes on ptxas' warnings and its notes of wgmma
    serialisation."""
    import chip_smoke

    log = (f"ptxas info    : Compiling entry function '{entry}' for 'sm_90a'\n"
           "    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 168 registers\n"
           "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions "
           "are serialized\n")
    assert chip_smoke.ptxas_summary(log) == [
        want, "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized"]
