"""DirectInversion's ablations in the PyTorch port vs the JAX package, at
TINY with 3 DDIM steps, f32 on the CPU: the recon-guided DDIM step, slerp,
the step gates, the mask dilation, the offsets replay, and the editor end to
end for ``ablation_directinversion_04+p2p``. The JAX loops are the JAX
editor's own jitted programs, so the offsets replay compiles once for the
function test and the strip."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_strips_match, jax_torch_editors, rel_err
from pnpinversion_tpu.inversion.ddim_inversion import make_step_gate as jax_make_step_gate
from pnpinversion_tpu.sampling import p2p_forward as jfwd
from pnpinversion_tpu.schedulers import ddim as jddim
from pnpinversion_tpu.utils import text as jtext
from pnpinversion_tpu_torch.inversion import ddim_inversion as tinv
from pnpinversion_tpu_torch.sampling import p2p_forward as tfwd
from pnpinversion_tpu_torch.schedulers import ddim as tddim
from pnpinversion_tpu_torch.utils import text as ttext

STEPS = 3
G = 7.5
# f32 on both sides; summation-order noise compounds over the UNet's depth
# and the loops. Relative to max |reference|, as test_torch_sampling.py.
RTOL = 1e-4
SRC, TAR = "a cat on a mat", "a silver cat on a mat"
P2P_KW = dict(blend_word=(("cat",), ("cat",)), eq_params={"words": ("silver",), "values": (2.0,)})


@pytest.fixture(scope="module")
def setup():
    jed, ted = jax_torch_editors(seed=31, steps=STEPS)
    rng = np.random.RandomState(32)
    arrays = dict(traj=rng.randn(STEPS + 1, 1, 8, 8, 4).astype(np.float32),
                  cond=rng.randn(2, 77, 32).astype(np.float32),
                  uncond=rng.randn(2, 77, 32).astype(np.float32))
    return jed, ted, arrays


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


@pytest.mark.parametrize("case", ["masked", "unmasked", "eta_noise"])
def test_ddim_step_recon_guided(case):
    rng = np.random.RandomState(33)
    x, eps, ref, noise = (rng.randn(2, 8, 8, 4).astype(np.float32) for _ in range(4))
    mask = (rng.rand(2, 8, 8, 4) > 0.5).astype(np.float32)
    kw = dict(recon_lr=0.3, recon_mask=mask if case == "masked" else None,
              eta=0.7 if case == "eta_noise" else 0.0,
              variance_noise=noise if case == "eta_noise" else None)
    js, ts = jddim.make_ddim_schedule(50), tddim.make_ddim_schedule(50)
    for t in (981, 481, 1):
        want = jddim.ddim_step_recon_guided(
            js, jnp.asarray(eps), jnp.asarray(t), jnp.asarray(x), jnp.asarray(ref),
            **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
        got = tddim.ddim_step_recon_guided(
            ts, _t(eps), t, _t(x), _t(ref),
            **{k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_slerp_tensor():
    rng = np.random.RandomState(34)
    low, high = (rng.randn(1, 77, 32).astype(np.float32) for _ in range(2))
    for val in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(ttext.slerp_tensor(val, low, high),
                                   jtext.slerp_tensor(val, low, high), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("scale,skip", [(0.4, 1), (1.0, 2)])
def test_make_step_gate(scale, skip):
    np.testing.assert_array_equal(tinv.make_step_gate(7, scale, skip),
                                  np.asarray(jax_make_step_gate(7, scale, skip)))


def test_dilate():
    m = (np.random.RandomState(35).rand(2, 8, 8, 4) > 0.8).astype(np.float32)
    for r in (1, 2):
        np.testing.assert_array_equal(tfwd._dilate(_t(m), r).numpy(),
                                      np.asarray(jfwd._dilate(jnp.asarray(m), r)))


@pytest.mark.parametrize("scale,skip", [(0.4, 1), (1.0, 2)])
def test_direct_inversion_offsets(setup, scale, skip):
    """The offsets replay with the gates of the _04 and interval_2 ablations."""
    jed, ted, arr = setup
    ctx = np.concatenate([arr["uncond"], arr["cond"]])
    want_loss, want_final = jed._offsets(
        jed.pipe.params["unet"], jnp.asarray(arr["traj"]), jnp.asarray(ctx),
        jnp.asarray(G, jnp.float32), jax_make_step_gate(STEPS, scale, skip, jnp.float32))
    with torch.inference_mode():
        got_loss, got_final = (x[0] for x in tinv.direct_inversion_offsets(
            ted.pipe.unet, ted.pipe.schedule, _t(arr["traj"])[None], _t(ctx)[None], G,
            tinv.make_step_gate(STEPS, scale, skip)))
    assert got_loss.shape == (STEPS, 2, 8, 8, 4)
    if skip == 2:
        assert not got_loss[1].any()  # the off-grid step's offsets are zero
    assert rel_err(got_loss, want_loss) <= RTOL
    assert rel_err(got_final, want_final) <= RTOL


def test_editor_strip(setup):
    """ablation_directinversion_04+p2p end to end through both packages'
    P2PEditor: the offsets replay at a 0.4 gate, the CFG reconstruction and
    the controlled edit with offsets on the source row."""
    jed, ted, _ = setup
    img = (np.random.RandomState(37).rand(16, 16, 3) * 255).astype(np.uint8)
    method = "ablation_directinversion_04+p2p"
    assert_strips_match(ted(method, img, SRC, TAR, **P2P_KW),
                        np.asarray(jed(method, img, SRC, TAR, **P2P_KW)))
