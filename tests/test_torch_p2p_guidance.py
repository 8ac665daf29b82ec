"""CFG inversion, the fused offsets+edit loop, ProxEdit's loop and
negative-prompt inversion of the PyTorch port vs the JAX package, at TINY
with 3 DDIM steps, f32 on the CPU. The JAX loops are the JAX editor's own
jitted programs, so the ProxEdit function test and the strip share one
compile."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_strips_match, jax_torch_editors, rel_err
from pnpinversion_tpu.control.p2p import P2PControl as JaxP2PControl
from pnpinversion_tpu.sampling import p2p_forward as jfwd
from pnpinversion_tpu_torch.control.base import NO_CONTROL
from pnpinversion_tpu_torch.control.p2p import P2PControl, stack_tensors
from pnpinversion_tpu_torch.inversion import ddim_inversion as tinv
from pnpinversion_tpu_torch.sampling import p2p_forward as tfwd

STEPS = 3
G = 7.5
# f32 on both sides, relative to max |reference|, as test_torch_sampling.py
RTOL = 1e-4
SRC, TAR = "a cat on a mat", "a silver cat on a mat"
P2P_KW = dict(blend_word=(("cat",), ("cat",)), eq_params={"words": ("silver",), "values": (2.0,)})
PROX_KW = dict(proximal="l0", quantile=0.75, use_inversion_guidance=True, recon_lr=1.0,
               recon_t=400)


@pytest.fixture(scope="module")
def setup():
    jed, ted = jax_torch_editors(seed=41, steps=STEPS)
    rng = np.random.RandomState(42)
    arrays = dict(traj=rng.randn(STEPS + 1, 1, 8, 8, 4).astype(np.float32),
                  cond=rng.randn(2, 77, 32).astype(np.float32),
                  uncond=rng.randn(2, 77, 32).astype(np.float32))
    controls = (jed._make_control([SRC, TAR], 0.4, 0.6, P2P_KW["blend_word"],
                                  P2P_KW["eq_params"], False),
                ted.make_control([SRC, TAR], **P2P_KW))
    return jed, ted, arrays, controls


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _g():
    return jnp.asarray(G, jnp.float32)  # the JAX editor's guidance argument


def test_ddim_invert_loop_cfg(setup):
    jed, ted, arr, _ = setup
    latent = arr["traj"][0]
    want = jed._invert_cfg(jed.pipe.params["unet"], jnp.asarray(latent),
                           jnp.asarray(arr["uncond"][:1]), jnp.asarray(arr["cond"][:1]),
                           jnp.asarray(2.5, jnp.float32))
    with torch.inference_mode():
        got = tinv.ddim_invert_loop_cfg(ted.pipe.unet, ted.pipe.schedule, _t(latent)[None],
                                        _t(arr["uncond"][:1])[None], _t(arr["cond"][:1])[None],
                                        2.5)[0]
    assert got.shape == (STEPS + 1, 1, 8, 8, 4)
    assert rel_err(got, want) <= RTOL


def test_fused_direct_inversion_edit(setup):
    """The 2B-row offsets+edit loop under P2P control, offsets on both rows,
    at a 0.8 gate."""
    jed, ted, arr, ((jspec, jt), (tspec, tt)) = setup
    row_mask = np.array([1.0, 1.0], np.float32)
    gate = np.full((STEPS,), 0.8, np.float32)
    jc, sched, ucfg = JaxP2PControl(jspec), jed.pipe.schedule, jed.pipe.config.unet
    want = jax.jit(lambda p, tr, c, u, tensors, rm, gt: jfwd.fused_direct_inversion_edit(
        p, sched, ucfg, tr, c, u, _g(), jc, tensors, rm, gt))(
        jed.pipe.params["unet"], jnp.asarray(arr["traj"]), jnp.asarray(arr["cond"]),
        jnp.asarray(arr["uncond"]), jt, jnp.asarray(row_mask), jnp.asarray(gate))
    with torch.inference_mode():
        got = tfwd.fused_direct_inversion_edit(
            ted.pipe.unet, ted.pipe.schedule, _t(arr["traj"])[None], _t(arr["cond"])[None],
            _t(arr["uncond"])[None], G, P2PControl(tspec), stack_tensors([tt]), _t(row_mask),
            gate)[0]
    assert got.shape == (2, 8, 8, 4)
    assert rel_err(got, want) <= RTOL


# (prox, quantile, recon_lr, recon_t, inversion_guidance, with image_enc): the
# batched class's ProxEdit settings (l0, a quantile, inversion guidance), and
# l1 with a fixed threshold, a negative recon_t and reconstruction guidance
PROX_CASES = [("l0", 0.75, 1.0, 400, True, False), ("l1", -0.05, 0.5, -400, False, True)]


@pytest.mark.parametrize("case", PROX_CASES, ids=["l0_quantile_inv", "l1_fixed_recon"])
def test_proximal_guidance_forward(setup, case):
    jed, ted, arr, ((jspec, jt), (tspec, tt)) = setup
    prox, quantile, lr, recon_t, inv, with_enc = case
    x_t, image_enc = arr["traj"][-1], arr["traj"][0]
    want = jed._forward_prox(jspec, True, prox, quantile, lr, recon_t, inv, 1, with_enc, True)(
        jed.pipe.params["unet"], jnp.asarray(x_t), jnp.asarray(arr["cond"]),
        jnp.asarray(arr["uncond"]), _g(), jt, jnp.asarray(image_enc), jnp.asarray(arr["traj"]))
    with torch.inference_mode():
        got = tfwd.proximal_guidance_forward(
            ted.pipe.unet, ted.pipe.schedule, _t(x_t)[None], _t(arr["cond"])[None],
            _t(arr["uncond"])[None], G, P2PControl(tspec), stack_tensors([tt]),
            edit_stage=True, prox=prox, quantile=quantile,
            image_enc=_t(image_enc)[None] if with_enc else None, recon_lr=lr,
            recon_t=recon_t, inversion_guidance=inv, x_stars=_t(arr["traj"])[None],
            dilate_mask=1)[0]
    assert rel_err(got, want) <= RTOL


def test_proximal_recon_stage_is_plain_cfg(setup):
    """Outside the edit stage the ProxEdit loop is plain CFG."""
    _, ted, arr, _ = setup
    args = (ted.pipe.unet, ted.pipe.schedule, _t(arr["traj"][-1])[None],
            _t(arr["cond"][:1])[None], _t(arr["uncond"][:1])[None], G)
    with torch.inference_mode():
        got = tfwd.proximal_guidance_forward(*args, NO_CONTROL, None, edit_stage=False,
                                             prox="l0", quantile=0.75)
        want = tfwd.guidance_forward(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_editor_strip(setup):
    """negative-prompt-inversion+proximal-guidance end to end through both
    packages' P2PEditor, with the fake uncond slerped halfway toward ""."""
    jed, ted, _, _ = setup
    img = (np.random.RandomState(43).rand(16, 16, 3) * 255).astype(np.uint8)
    method, kw = "negative-prompt-inversion+proximal-guidance", dict(
        P2P_KW, npi_interp=0.5, **PROX_KW)
    assert_strips_match(ted(method, img, SRC, TAR, **kw),
                        np.asarray(jed(method, img, SRC, TAR, **kw)))
