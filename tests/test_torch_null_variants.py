"""The null-text variants of the PyTorch port vs the JAX package, at TINY
with 3 DDIM steps, f32 on the CPU: the single-branch CFG loop, and the
editor end to end for ``ablation_null-text-inversion_single_branch+p2p`` and
``null-text-inversion+proximal-guidance``. The JAX loops are the JAX
editor's own jitted programs, so its null-text optimisation compiles once
for both strips."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_strips_match, jax_torch_editors, rel_err
from pnpinversion_tpu_torch.control.p2p import P2PControl, stack_tensors
from pnpinversion_tpu_torch.sampling import p2p_forward as tfwd

STEPS = 3
G = 7.5
# f32 on both sides, relative to max |reference|, as test_torch_sampling.py
RTOL = 1e-4
SRC, TAR = "a cat on a mat", "a silver cat on a mat"
P2P_KW = dict(blend_word=(("cat",), ("cat",)), eq_params={"words": ("silver",), "values": (2.0,)})


@pytest.fixture(scope="module")
def editors():
    return jax_torch_editors(seed=51, steps=STEPS)


def test_guidance_forward_single_branch(editors):
    jed, ted = editors
    rng = np.random.RandomState(52)
    x_t = rng.randn(1, 8, 8, 4).astype(np.float32)
    cond, uncond = (rng.randn(2, 77, 32).astype(np.float32) for _ in range(2))
    uncond_steps = rng.randn(STEPS, 1, 77, 32).astype(np.float32)
    jspec, jt = jed._make_control([SRC, TAR], 0.4, 0.6, P2P_KW["blend_word"],
                                  P2P_KW["eq_params"], False)
    tspec, tt = ted.make_control([SRC, TAR], **P2P_KW)
    want = jed._forward_single_branch(jspec)(
        jed.pipe.params["unet"], jnp.asarray(x_t), jnp.asarray(cond), jnp.asarray(uncond_steps),
        jnp.asarray(uncond), jnp.asarray(G, jnp.float32), jt)
    with torch.inference_mode():
        got = tfwd.guidance_forward_single_branch(
            ted.pipe.unet, ted.pipe.schedule, *(torch.from_numpy(a)[None] for a in (
                x_t, cond, uncond_steps, uncond)), G, P2PControl(tspec), stack_tensors([tt]))[0]
    assert got.shape == (2, 8, 8, 4)
    assert rel_err(got, want) <= RTOL


@pytest.mark.parametrize("method,kw", [
    ("ablation_null-text-inversion_single_branch+p2p", {}),
    ("null-text-inversion+proximal-guidance",
     dict(proximal="l1", quantile=0.6, use_reconstruction_guidance=True, recon_lr=0.5,
          recon_t=600, dilate_mask=2)),
], ids=["single_branch", "proximal"])
def test_editor_strip(editors, method, kw):
    jed, ted = editors
    img = (np.random.RandomState(53).rand(16, 16, 3) * 255).astype(np.uint8)
    assert_strips_match(ted(method, img, SRC, TAR, **P2P_KW, **kw),
                        np.asarray(jed(method, img, SRC, TAR, **P2P_KW, **kw)))
