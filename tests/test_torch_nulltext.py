"""Null-text inversion, the per-step-uncond CFG loop under P2P control and the
null-text-inversion+p2p / ddim+p2p editors of the PyTorch port vs the JAX
package, at TINY with 3 DDIM steps, f32 on the CPU. The JAX results that two
tests share come from one JAX editor, so each jitted program compiles once."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import jax_pipeline, pipeline_params, rel_err, torch_pipeline
from pnpinversion_tpu.configs import TINY as JTINY
from pnpinversion_tpu.editors.p2p_editor import P2PEditor as JaxP2PEditor
from pnpinversion_tpu.models.unet import unet_apply
from pnpinversion_tpu.schedulers import ddim as jddim
from pnpinversion_tpu.utils.tokenizer import SimpleWordTokenizer as JaxTokenizer
from pnpinversion_tpu_torch.control.p2p import P2PControl, stack_tensors
from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor
from pnpinversion_tpu_torch.inversion.ddim_inversion import _adam_step, null_text_optimization
from pnpinversion_tpu_torch.ops import attention as tattn
from pnpinversion_tpu_torch.ops import flash_attention as tflash
from pnpinversion_tpu_torch.sampling.p2p_forward import guidance_forward
from pnpinversion_tpu_torch.schedulers import ddim as tddim
from pnpinversion_tpu_torch.utils.tokenizer import default_tokenizer

STEPS = 3
INNER = 10  # the editors' num_inner_steps
G = 7.5
SRC, TAR = "a cat on a mat", "a silver cat on a mat"
P2P_KW = dict(blend_word=(("cat",), ("cat",)), eq_params={"words": ("silver",), "values": (2.0,)})
# f32 on both sides, relative to max |reference|: summation-order noise of
# the UNet's forward and backward
GRAD_RTOL = 1e-4
# the loops: the UNet's f32 noise compounds over the steps, and Adam's update
# ~ lr * g / |g| turns a relative gradient error e into an embedding error of
# about lr * e per step wherever |g| is far above Adam's eps (1e-8)
LOOP_RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    params = pipeline_params(JTINY, seed=21)
    jpipe, tpipe = jax_pipeline(params, STEPS), torch_pipeline(params, STEPS)
    jpipe.tokenizer, tpipe.tokenizer = JaxTokenizer(), default_tokenizer()
    rng = np.random.RandomState(22)
    arrays = dict(traj=rng.randn(STEPS + 1, 1, 8, 8, 4).astype(np.float32),
                  cond=rng.randn(2, 77, 32).astype(np.float32),
                  uncond=rng.randn(2, 77, 32).astype(np.float32))
    return jpipe, tpipe, JaxP2PEditor(jpipe), arrays, _jax_inner_value_and_grad(jpipe)


def _jax_inner_value_and_grad(jpipe):
    """jit of the loss and gradient of the JAX package's null-text loss_fn."""
    def loss(p, u, lat, t, eps_cond, prev):
        eps_u, _ = unet_apply(p, lat, t, u, jpipe.config.unet)
        eps = jddim.classifier_free_guidance(eps_u, eps_cond, G)
        d = (jddim.ddim_step(jpipe.schedule, eps, t, lat) - prev).astype(jnp.float32)
        return jnp.mean(d * d)

    return jax.jit(jax.value_and_grad(loss, argnums=1))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _torch_inner_loss(tpipe, u, lat, t, eps_cond, prev):
    eps_u, _ = tpipe.unet(lat, t, u)
    eps = tddim.classifier_free_guidance(eps_u, eps_cond, G)
    d = (tddim.ddim_step(tpipe.schedule, eps, t, lat) - prev).float()
    return (d * d).mean()


@pytest.mark.parametrize("i", [0, 1])
def test_inner_step_gradient(setup, i):
    """Loss and gradient of one inner Adam step w.r.t. the uncond embedding,
    through the whole UNet (the JAX package's null-text ``loss_fn``). Not at
    the last step: there t = 0 and alpha_t == alpha_prev, so the DDIM step is
    the identity and the gradient is zero up to rounding (JAX ~1e-13, the
    port exactly 0); Adam's eps of 1e-8 keeps such noise from moving u."""
    jpipe, tpipe, _, arr, jgrad = setup
    rng = np.random.RandomState(23 + i)
    lat, prev, eps_cond = (rng.randn(1, 8, 8, 4).astype(np.float32) for _ in range(3))
    u = arr["uncond"][:1]
    t = jpipe.schedule.timesteps[i]
    want_loss, want_grad = jgrad(jpipe.params["unet"], u, lat, t, eps_cond, prev)
    ut = _t(u).requires_grad_(True)
    loss = _torch_inner_loss(tpipe, ut, _t(lat), int(t), _t(eps_cond), _t(prev))
    (grad,) = torch.autograd.grad(loss, ut)
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * float(want_loss)
    assert rel_err(grad, want_grad) <= GRAD_RTOL


def test_inner_step_gradient_through_flash_function(setup, monkeypatch):
    """The same gradient with every self-attention site routed through the
    FlashAttention autograd Function (its plain versions on the CPU): the
    Function saves and differentiates the UNet's strided head views right."""
    _, tpipe, _, arr, _ = setup
    rng = np.random.RandomState(25)
    lat, prev, eps_cond = (_t(rng.randn(1, 8, 8, 4).astype(np.float32)) for _ in range(3))
    t = tpipe.schedule.timesteps[1]

    def grad():
        u = _t(arr["uncond"][:1]).requires_grad_(True)
        return torch.autograd.grad(_torch_inner_loss(tpipe, u, lat, t, eps_cond, prev), u)[0]

    want = grad()
    calls = []

    def counted(*a):
        calls.append(1)
        return tflash.FlashAttention.apply(*a)

    monkeypatch.setattr(tattn, "use_flash", lambda q, k: q.shape[2] == k.shape[2])
    monkeypatch.setattr(tattn, "flash_attention", counted)
    got = grad()
    assert len(calls) == len(tpipe.unet.sites)  # one per self-attention site
    assert rel_err(got, want) <= 1e-5


# JAX programs are called with the argument types the JAX editor uses (a
# strongly typed f32 guidance scale), so the strip tests reuse their compiles
def _jax_null_text(setup):
    jpipe, _, jed, arr, _ = setup
    return jed._null_text(INNER)(jpipe.params["unet"], jnp.asarray(arr["traj"]),
                                 jnp.asarray(arr["uncond"][:1]), jnp.asarray(arr["cond"][:1]),
                                 jnp.asarray(G, jnp.float32))


def test_null_text_optimization(setup):
    jpipe, tpipe, _, arr, _ = setup
    want = _jax_null_text(setup)
    got = null_text_optimization(tpipe.unet, tpipe.schedule, _t(arr["traj"])[None],
                                 _t(arr["uncond"][:1])[None], _t(arr["cond"][:1])[None], G,
                                 num_inner_steps=INNER)[0]
    assert got.shape == (STEPS, 1, 77, 32)
    assert not np.allclose(got[0].numpy(), arr["uncond"][:1])
    assert rel_err(got, want) <= LOOP_RTOL


def test_null_text_updates_before_the_early_stop(setup):
    """An epsilon that every loss is under stops each outer step after one
    inner step, and that step's Adam update is applied first: the result is
    that of num_inner_steps=1, not the starting embedding."""
    _, tpipe, _, arr, _ = setup
    args = (tpipe.unet, tpipe.schedule, _t(arr["traj"])[None], _t(arr["uncond"][:1])[None],
            _t(arr["cond"][:1])[None], G)
    stopped = null_text_optimization(*args, num_inner_steps=INNER, epsilon=1e3)[0]
    one_step = null_text_optimization(*args, num_inner_steps=1, epsilon=0.0)[0]
    torch.testing.assert_close(stopped, one_step, rtol=0, atol=0)
    # Adam's first step moves every component with a non-zero gradient by
    # ~lr = 1e-2 (1 - i/100)
    step = (stopped[0, 0] - _t(arr["uncond"][:1])[0]).abs()
    assert step.max().item() <= 1.01e-2 and step.median().item() >= 0.9e-2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_adam_step_matches_optax(dtype):
    """Five steps of the port's Adam vs optax ``adam(1.0)`` scaled by lr, as
    the JAX package applies it, on gradients spread over six decades. In bf16
    (the card's dtype) every rounding is the leaf dtype's, so u, mu and nu
    agree bit for bit; in f32 XLA may fuse the moments' multiply-adds, so u
    is held to one f32 ulp of its magnitude."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.RandomState(26)
    u0 = rng.randn(1, 77, 32).astype(np.float32)
    lr = np.float32(1e-2) * (np.float32(1.0) - np.float32(3) / np.float32(100.0))
    opt = optax.adam(1.0)

    @jax.jit
    def jstep(u, state, g):
        updates, state = opt.update(g, state, u)
        return optax.apply_updates(u, jax.tree.map(lambda x: x * lr, updates)), state

    ju = jnp.asarray(u0, jdt)
    state = opt.init(ju)
    tu = _t(u0).to(tdt)
    mu, nu = torch.zeros_like(tu), torch.zeros_like(tu)
    for j in range(1, 6):
        g = (rng.randn(1, 77, 32) * 10.0 ** rng.uniform(-6, 0, (1, 77, 32))).astype(np.float32)
        ju, state = jstep(ju, state, jnp.asarray(g, jdt))
        tu, mu, nu = _adam_step(tu, _t(g).to(tdt), mu, nu, j, float(lr))
    want_u = np.asarray(ju.astype(jnp.float32))
    if dtype == "bfloat16":
        for got, want in ((tu, ju), (mu, state[0].mu), (nu, state[0].nu)):
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want.astype(jnp.float32)))
    else:
        assert np.abs(tu.numpy() - want_u).max() <= np.spacing(np.abs(want_u).max())


def test_guidance_forward_per_step_uncond_p2p(setup):
    """The edit loop of null-text+p2p: per-step uncond (T, 1, 77, D) broadcast
    to B rows, 2B UNet rows, P2P refine + LocalBlend + reweight with the uncond
    half of B rows (uncond_rows=-1); per-step offsets on the source row (the
    editors pass none, and the JAX editor zeros: same program)."""
    jpipe, tpipe, jed, arr, _ = setup
    rng = np.random.RandomState(24)
    uncond_steps = rng.randn(STEPS, 1, 77, 32).astype(np.float32)
    noise_loss = 0.1 * rng.randn(STEPS, 2, 8, 8, 4).astype(np.float32)
    row_mask = np.array([1.0, 0.0], np.float32)
    x_t = arr["traj"][-1]
    jspec, jt = jed._make_control([SRC, TAR], 0.4, 0.6, P2P_KW["blend_word"],
                                  P2P_KW["eq_params"], False)
    tspec, tt = P2PEditor(tpipe).make_control([SRC, TAR], **P2P_KW)
    assert tspec.uncond_rows == -1 and tspec.half == 2 and tspec.local_blend and tspec.reweight
    want = jed._forward(jspec)(jpipe.params["unet"], jnp.asarray(x_t),
                               jnp.asarray(arr["cond"]), jnp.asarray(uncond_steps),
                               jnp.asarray(G, jnp.float32), jt, jnp.asarray(noise_loss),
                               jnp.asarray(row_mask))
    with torch.no_grad():
        got = guidance_forward(tpipe.unet, tpipe.schedule, _t(x_t)[None], _t(arr["cond"])[None],
                               _t(uncond_steps)[None], G, P2PControl(tspec),
                               stack_tensors([tt]), _t(noise_loss)[None], _t(row_mask))[0]
    assert got.shape == (2, 8, 8, 4)
    assert rel_err(got, want) <= LOOP_RTOL


@pytest.mark.parametrize("method", ["null-text-inversion+p2p", "ddim+p2p"])
def test_editor_strip(setup, method):
    """The method end to end: the same image and prompts through both
    packages' P2PEditor."""
    jpipe, tpipe, jed, _, _ = setup
    img = (np.random.RandomState(26).rand(16, 16, 3) * 255).astype(np.uint8)
    want = np.asarray(jed(method, img, SRC, TAR, **P2P_KW))
    got = P2PEditor(tpipe)(method, img, SRC, TAR, **P2P_KW)
    assert got.shape == want.shape == (16, 64, 3) and got.dtype == np.uint8
    # the instruction and ground-truth panels are exact; the decoded panels
    # are truncated to uint8, which flips a value wherever the f32 noise of
    # the loops and a decode straddles an integer
    np.testing.assert_array_equal(got[:, :32], want[:, :32])
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
