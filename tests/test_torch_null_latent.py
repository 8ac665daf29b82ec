"""The null-latent ablation of the PyTorch port vs the JAX package, at TINY
with 3 DDIM steps, f32 on the CPU: the null-latent offsets and the editor
end to end for ``ablation_null-latent-inversion+p2p``. The JAX side is the
JAX editor's own jitted program, so it compiles once for both tests."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_strips_match, jax_torch_editors, rel_err
from pnpinversion_tpu_torch.inversion import ddim_inversion as tinv

STEPS = 3
G = 7.5
# f32 on both sides, relative to max |reference|, as test_torch_nulltext.py
RTOL = 1e-4
SRC, TAR = "a cat on a mat", "a silver cat on a mat"
P2P_KW = dict(blend_word=(("cat",), ("cat",)), eq_params={"words": ("silver",), "values": (2.0,)})


@pytest.fixture(scope="module")
def setup():
    jed, ted = jax_torch_editors(seed=71, steps=STEPS)
    rng = np.random.RandomState(72)
    arrays = dict(traj=rng.randn(STEPS + 1, 1, 8, 8, 4).astype(np.float32),
                  cond=rng.randn(2, 77, 32).astype(np.float32),
                  uncond=rng.randn(2, 77, 32).astype(np.float32))
    return jed, ted, arrays


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def test_null_latent_offsets(setup):
    """Adam through the UNet (10 inner steps, the editor's default); the
    offsets of rows 1+ are exactly zero on both sides."""
    jed, ted, arr = setup
    ctx = np.concatenate([arr["uncond"], arr["cond"]])
    want = jed._null_latent(10)(jed.pipe.params["unet"], jnp.asarray(arr["traj"]),
                                jnp.asarray(ctx), jnp.asarray(G, jnp.float32))
    got = tinv.null_latent_offsets(ted.pipe.unet, ted.pipe.schedule, _t(arr["traj"])[None],
                                   _t(ctx)[None], G, num_inner_steps=10)[0]
    assert got.shape == (STEPS, 2, 8, 8, 4)
    assert not got[:, 1].any() and not np.asarray(want)[:, 1].any()
    assert got[:, 0].abs().max() > 0
    assert rel_err(got, want) <= RTOL


def test_editor_strip(setup):
    """The method end to end through both packages' P2PEditor: the
    null-latent offsets on the source row of the CFG reconstruction and of
    the controlled edit."""
    jed, ted, _ = setup
    img = (np.random.RandomState(73).rand(16, 16, 3) * 255).astype(np.uint8)
    method = "ablation_null-latent-inversion+p2p"
    assert_strips_match(ted(method, img, SRC, TAR, **P2P_KW),
                        np.asarray(jed(method, img, SRC, TAR, **P2P_KW)))
