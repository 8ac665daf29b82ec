"""StyleDiffusion in the PyTorch port vs the JAX package, at TINY with 3 DDIM
steps and 3 inner steps, f32 on the CPU (a tiny CLIP tower whose width is
the UNet's context width): the mapping networks, both controls' row gating,
the map-recording inversion, the inner-step schedule, the network training,
the replace rule, the editor's strip, and the batched training and class
against the port's single-image runs, with one image stopping its inner loop
early and the other not.

The weights (UNet, VAE, text, CLIP tower, the networks' start) go to both
sides from one numpy tree; the JAX programs of the function tests are the
JAX editor's own (its jit cache), compiled once by the module's fixture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    assert_panels_close,
    assert_strips_match,
    jax_torch_pipelines,
    numpy_params,
    rel_err,
    seeded_images,
)
from pnpinversion_tpu.control import stylediffusion as jctl
from pnpinversion_tpu.control.base import AttnSite as JaxSite
from pnpinversion_tpu.editors import stylediffusion_editor as jed_mod
from pnpinversion_tpu.inversion import stylediffusion as jinv
from pnpinversion_tpu.models import stylediffusion as jsd
from pnpinversion_tpu.models import vit as jvit
from pnpinversion_tpu.models.unet import unet_apply
from pnpinversion_tpu_torch.control import stylediffusion as tctl
from pnpinversion_tpu_torch.control.base import AttnSite
from pnpinversion_tpu_torch.control.p2p import stack_tensors
from pnpinversion_tpu_torch.convert import from_jax_params, stylediffusion_mapper_from_jax
from pnpinversion_tpu_torch.editors import stylediffusion_editor as ted_mod
from pnpinversion_tpu_torch.inversion import stylediffusion as tinv
from pnpinversion_tpu_torch.models import stylediffusion as tsd
from pnpinversion_tpu_torch.models.vit import ViTConfig
from pnpinversion_tpu_torch.parallel.sweep import BatchedStyleDiffusion

torch.set_num_threads(2)

STEPS = 3
INNER = 3
PROMPTS = ("a cat on a mat", "a dog on a mat")
VOCAB = "a cat on mat dog big red ball"
CLIP = dict(image_size=16, patch_size=8, width=32, layers=2, heads=2, projection_dim=16)
TOKENS = 5  # (16 / 8)^2 patches + the class token
# relative to max |JAX|, f32 on both sides: forward-only functions, and the
# Adam loops (null-text's LOOP_RTOL)
RTOL = 1e-5
LOOP_RTOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def assert_networks_close(got, want, unet, latent, cond, tokens, timesteps, rtol):
    """Trained networks (N, T, ...) compared by what the UNet makes of them:
    its eps from latent (N, h, w, c) and cond (N, 77, D) under each step's
    networks (StyleTrainControl, one row an image), within ``rtol`` of max.

    Not by their raw parameters, nor by the V-context rows they map: Adam
    moves every coordinate by about lr, the sign of its gradient, however
    small that gradient. The biases right before the batch-statistics norm
    (``conv_start.bias``, ``blocks.*.conv.bias``) cancel in it, so their
    exact gradient is 0; the rows of the mapped context that the attention
    barely reads have gradients near 0. Both move by the sign of rounding
    noise, which differs between the packages and between batch sizes (a
    single Adam step from gradients within 1.3e-6 of each other left
    ``conv_end.kernel`` 6.9e-4 of max apart); the UNet's eps does not see
    them."""
    assert sorted(got) == sorted(want)
    assert all(got[k].shape == want[k].shape for k in want)
    for s in range(want["conv_start.kernel"].shape[1]):
        eps = [unet(latent, timesteps[s], cond, tctl.StyleTrainControl("all"),
                    {"sd_mapper_i": tsd.mapper_at_step(m, s), "img_tokens": tokens}, {}, s)[0]
               for m in (got, want)]
        assert rel_err(*eps) <= rtol, s


def _mapper(seed: int, steps: int):
    """A random stacked JAX mapper tree (steps, ...) with numpy leaves."""
    return numpy_params(lambda k, _: jsd.init_mapper_params(k, steps, tokens_in=TOKENS,
                                                            width=32), None, seed)


def _stack(trees, **kw):
    """JAX trees, one per image -> the port's (N, ...) dict."""
    per = [stylediffusion_mapper_from_jax(t, **kw) for t in trees]
    return {k: torch.cat([p[k] for p in per]) for k in per[0]}


@pytest.fixture(scope="module")
def setup():
    """Both pipelines and CLIP towers, both editors, the networks' start,
    and the JAX editor's strip (compiling its programs once)."""
    jpipe, tpipe = jax_torch_pipelines(seed=601, steps=STEPS)
    for p in (jpipe, tpipe):  # the word tokenizers number words as first seen
        p.encode_prompt([VOCAB])
    cparams = numpy_params(jvit.init_vit_params, jvit.ViTConfig(**CLIP), 602)
    jed = jed_mod.StyleDiffusionEditor(jpipe, jax.tree.map(jnp.asarray, cparams),
                                       jvit.ViTConfig(**CLIP))
    ted = ted_mod.StyleDiffusionEditor(tpipe, from_jax_params(cparams, ViTConfig(**CLIP)).eval())
    m0 = jsd.mapper_at_step(jsd.init_mapper_params(jax.random.PRNGKey(0), 1, tokens_in=TOKENS,
                                                   width=32), 0)
    img = seeded_images(603, 1)[0]
    strip = np.asarray(jed(ted_mod.METHOD, img, *PROMPTS, num_inner_steps=INNER))
    return jpipe, tpipe, jed, ted, stylediffusion_mapper_from_jax(m0), img, strip


def test_mapper_and_forward_embed_match_jax():
    """Two images, each with its own networks and tokens: each image's
    mapped tensor against JAX's at one step; a bf16 context promotes to f32."""
    trees = [_mapper(604, 2), _mapper(605, 2)]
    rng = np.random.RandomState(606)
    tokens = rng.randn(2, TOKENS, 32).astype(np.float32)
    ctx = rng.randn(2, 2, 77, 32).astype(np.float32)
    step = 1
    mp = tsd.mapper_at_step(_stack(trees), step)
    emb = tsd.mapper_apply(mp, _t(tokens))
    out = tsd.forward_embed(mp, _t(ctx), _t(tokens))
    assert emb.shape == (2, 154, 32) and out.shape == (2, 2, 77, 32)
    for i, tree in enumerate(trees):
        jmp = jsd.mapper_at_step(jax.tree.map(jnp.asarray, tree), step)
        assert rel_err(emb[i], jsd.mapper_apply(jmp, jnp.asarray(tokens[i : i + 1]))[0]) <= RTOL
        want = jsd.forward_embed(jmp, jnp.asarray(ctx[i]), jnp.asarray(tokens[i : i + 1]))
        assert rel_err(out[i], want) <= RTOL
    bf = tsd.forward_embed(mp, _t(ctx).bfloat16(), _t(tokens))
    jbf = jsd.forward_embed(jsd.mapper_at_step(jax.tree.map(jnp.asarray, trees[0]), step),
                            jnp.asarray(ctx[0], jnp.bfloat16), jnp.asarray(tokens[:1]))
    assert bf.dtype == torch.float32 and jbf.dtype == jnp.float32


def _sites():
    return (JaxSite(0, "down", 4, True, 2, 0, 0), AttnSite(0, "down", 4, True, 2, 0, 0),
            AttnSite(1, "down", 4, False, 2, 0, -1))


@pytest.mark.parametrize("step", [0, 2], ids=["mapped", "target_unmapped"])
def test_edit_control_gates_rows_like_jax(step):
    """StyleDiffusionControl's V context for 2 images of [uncond x 2, cond x
    2] rows: the uncond rows as they were, the source row always mapped, the
    target row mapped only while step < v_replace_end (2 of 3); self sites
    untouched."""
    trees = [_mapper(607, STEPS), _mapper(608, STEPS)]
    rng = np.random.RandomState(609)
    tokens = rng.randn(2, TOKENS, 32).astype(np.float32)
    ctx = rng.randn(2, 4, 77, 32).astype(np.float32)
    jsite, site, self_site = _sites()
    spec = dict(batch_size=2, num_steps=STEPS, v_replace_end=2)
    ours = tctl.StyleDiffusionControl(tctl.StyleDiffusionSpec(**spec))
    tensors = {"img_tokens": _t(tokens), "sd_mapper": _stack(trees)}
    got = ours.value_context_hook(site, _t(ctx).reshape(8, 77, 32), tensors, {}, step)
    assert got.shape == (8, 77, 32)
    ref = jctl.StyleDiffusionControl(jctl.StyleDiffusionSpec(**spec))
    for i, tree in enumerate(trees):
        want = ref.value_context_hook(
            jsite, jnp.asarray(ctx[i]), {"img_tokens": jnp.asarray(tokens[i : i + 1]),
                                         "sd_mapper": jax.tree.map(jnp.asarray, tree)},
            {}, jnp.int32(step))
        assert rel_err(got[4 * i : 4 * i + 4], want) <= RTOL
    np.testing.assert_array_equal(got[:2].numpy(), ctx[0, :2])
    assert np.array_equal(got[3].numpy(), ctx[0, 3]) == (step >= 2)
    plain = _t(ctx).reshape(8, 77, 32)
    assert ours.value_context_hook(self_site, plain, tensors, {}, step) is plain


@pytest.mark.parametrize("rows", ["all", "cond_half"])
def test_train_control_maps_rows_like_jax(rows):
    """StyleTrainControl with one step's networks: every row mapped ('all',
    1 row an image) or each image's cond half ('cond_half', 2 rows)."""
    trees = [_mapper(610, 1), _mapper(611, 1)]
    r = 1 if rows == "all" else 2
    rng = np.random.RandomState(612)
    tokens = rng.randn(2, TOKENS, 32).astype(np.float32)
    ctx = rng.randn(2, r, 77, 32).astype(np.float32)
    jsite, site, _ = _sites()
    mp = tsd.mapper_at_step(_stack(trees), 0)
    got = tctl.StyleTrainControl(rows).value_context_hook(
        site, _t(ctx).reshape(2 * r, 77, 32), {"sd_mapper_i": mp, "img_tokens": _t(tokens)},
        {}, 0)
    for i, tree in enumerate(trees):
        want = jctl.StyleTrainControl(rows).value_context_hook(
            jsite, jnp.asarray(ctx[i]), {"sd_mapper_i": jsd.mapper_at_step(
                jax.tree.map(jnp.asarray, tree), 0), "img_tokens": jnp.asarray(tokens[i : i + 1])},
            {}, jnp.int32(0))
        assert rel_err(got[r * i : r * i + r], want) <= RTOL
    if rows == "cond_half":
        np.testing.assert_array_equal(got[::2].numpy(), ctx[:, 0])


@pytest.mark.parametrize("tau_u", [0.0, 0.67], ids=["window_off", "uncond_window"])
def test_edit_control_unet_call_matches_jax(setup, tau_u):
    """One UNet call of [uncond x 2, cond x 2] rows under the edit pass's
    control (P2P replace, tau_v 0.5, the networks mapping the V context)
    at step 0, inside P2P's self-replace window, with the tau_u window off
    (self-attention through P2P's override) and on (every self site of at
    most 32^2 through the probs path, P2P's self replace and the uncond
    rows' in the hook, which moves eps): eps within 1e-5 of max."""
    from pnpinversion_tpu.control.p2p import make_p2p_control as jax_p2p

    jpipe, tpipe, *_ = setup
    rng = np.random.RandomState(618)
    x = rng.randn(4, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(4, 77, 32).astype(np.float32)
    tokens = rng.randn(1, TOKENS, 32).astype(np.float32)
    tree = _mapper(619, STEPS)
    taus = (0.5, 0.6, 0.6, tau_u)
    spec = dict(batch_size=2, num_steps=STEPS, v_replace_end=int(0.5 * STEPS),
                uncond_self_start=0, uncond_self_end=int(tau_u * STEPS))
    jc, jt = jax_p2p(list(PROMPTS), jpipe.tokenizer, num_steps=STEPS,
                     cross_replace_steps={"default_": 0.6}, self_replace_steps=0.6,
                     is_replace_controller=True, num_lb_slots=jpipe.num_lb_slots,
                     lb_res=jpipe.lb_res, latent_size=jpipe.latent_size)
    want, _ = jax.jit(lambda p, x, c, t: unet_apply(
        p, x, jnp.int32(334), c, jpipe.config.unet,
        jctl.StyleDiffusionControl(jctl.StyleDiffusionSpec(**spec), jc), t, {},
        step=jnp.int32(0)))(jpipe.params["unet"], jnp.asarray(x), jnp.asarray(ctx),
                            {**jt, "img_tokens": jnp.asarray(tokens),
                             "sd_mapper": jax.tree.map(jnp.asarray, tree)})
    tc, tt = ted_mod.stylediffusion_p2p(tpipe, list(PROMPTS), taus=taus)
    assert tc.spec.kind == "replace" and tc.spec.self_replace_end == int(0.6 * STEPS)
    tensors = {**stack_tensors([tt]), "img_tokens": _t(tokens), "sd_mapper": _stack([tree])}
    with torch.no_grad():
        got, plain = (tpipe.unet(_t(x), 334, _t(ctx), tctl.StyleDiffusionControl(
            tctl.StyleDiffusionSpec(**{**spec, "uncond_self_end": end}), tc), tensors, {}, 0)[0]
            for end in (spec["uncond_self_end"], 0))
    assert rel_err(got, want) <= RTOL
    assert (rel_err(got, plain) > 1e-3) == (tau_u > 0)


def test_inner_steps_schedule_matches_jax():
    for T, K in ((50, 100), (3, 3), (10, 7)):
        np.testing.assert_array_equal(tinv.inner_steps_schedule(T, K),
                                      jinv.inner_steps_schedule(T, K))
    assert tinv.inner_steps_schedule(50, 100).sum() == 1071  # the reference run's most


@pytest.mark.parametrize("pair", [("a cat", "a dog"), ("a cat on a mat", "a dog in a box"),
                                  ("a big cat", "a cat"), ("a b cd", "ab c d"),
                                  (" a cat ", "a dog"), ("red", "big")])
def test_replace_rule_matches_jax(pair):
    assert ted_mod.stylediffusion_is_replace(*pair) == jed_mod.stylediffusion_is_replace(*pair)


def test_invert_with_maps_matches_jax(setup):
    """The trajectory and the 16^2-slot cross maps of every step (the JAX
    editor's jitted inversion)."""
    jpipe, tpipe, jed, *_ = setup
    rng = np.random.RandomState(613)
    lat, emb = rng.randn(1, 8, 8, 4).astype(np.float32), rng.randn(1, 77, 32).astype(np.float32)
    traj, maps = jed._jit_cache["inv"](jpipe.params["unet"], jnp.asarray(lat), jnp.asarray(emb))
    with torch.no_grad():
        got_traj, got_maps = tinv.ddim_invert_with_maps(tpipe.unet, tpipe.schedule,
                                                        _t(lat)[None], _t(emb)[None])
    assert rel_err(got_traj[0], traj) <= RTOL
    assert sorted(got_maps) == sorted(maps) and len(got_maps) == tpipe.num_lb_slots
    for k in maps:
        assert got_maps[k].shape == (1,) + tuple(maps[k].shape)
        assert rel_err(got_maps[k][0], maps[k]) <= RTOL


def _train_inputs(seed: int, n: int = 1):
    rng = np.random.RandomState(seed)
    return dict(traj=rng.randn(n, STEPS + 1, 1, 8, 8, 4).astype(np.float32),
                tokens=rng.randn(n, TOKENS, 32).astype(np.float32),
                uncond=rng.randn(n, 1, 77, 32).astype(np.float32),
                cond=rng.randn(n, 1, 77, 32).astype(np.float32))


def test_train_mappers_matches_jax(setup):
    """3 steps of at most 3 Adam steps each (the JAX editor's jitted
    training): every step's trained networks."""
    jpipe, tpipe, jed, _, m0, *_ = setup
    a = _train_inputs(614)
    with torch.no_grad():
        traj, maps = tinv.ddim_invert_with_maps(tpipe.unet, tpipe.schedule, _t(a["traj"][:, 0]),
                                                _t(a["cond"]))
        got = tinv.train_mappers(tpipe.unet, tpipe.schedule, _t(a["traj"]), maps,
                                 _t(a["tokens"]), _t(a["uncond"]), _t(a["cond"]), 7.5, m0,
                                 num_inner_steps=INNER)
    want = jed._jit_cache[("train", INNER)](
        jpipe.params["unet"], jnp.asarray(a["traj"][0]),
        {k: jnp.asarray(v[0].numpy()) for k, v in maps.items()}, jnp.asarray(a["tokens"]),
        jnp.asarray(a["uncond"][0]), jnp.asarray(a["cond"][0]), jnp.asarray(7.5, jnp.float32),
        jax.tree.map(lambda v: jnp.asarray(v[0].numpy()), _unflat(m0)))
    want = stylediffusion_mapper_from_jax(jax.tree.map(np.asarray, want))
    assert got["conv_end.kernel"].shape == (1, STEPS) + tuple(m0["conv_end.kernel"].shape[1:])
    with torch.no_grad():
        assert_networks_close(got, want, tpipe.unet, _t(a["traj"][:, -1, 0]),
                              _t(a["cond"][:, 0]), _t(a["tokens"]), tpipe.schedule.timesteps,
                              LOOP_RTOL)
    assert rel_err(got["conv_start.kernel"][:, 0], m0["conv_start.kernel"]) > 1e-4  # trained


def _unflat(p):
    """The port's flat networks -> the JAX tree layout (same leaves)."""
    blocks = []
    b = 0
    while f"blocks.{b}.bn_scale" in p:
        blocks.append({"conv": {"kernel": p[f"blocks.{b}.conv.kernel"],
                                "bias": p[f"blocks.{b}.conv.bias"]},
                       "bn_scale": p[f"blocks.{b}.bn_scale"], "bn_bias": p[f"blocks.{b}.bn_bias"]})
        b += 1
    return {"conv_start": {"kernel": p["conv_start.kernel"], "bias": p["conv_start.bias"]},
            "blocks": blocks,
            "conv_end": {"kernel": p["conv_end.kernel"], "bias": p["conv_end.bias"]}}


def test_batched_training_stops_each_image_on_its_own(setup):
    """Two images trained together with epsilon 1.0: image 1's step-0 maps
    are what its start networks give and its target latent 0.3 sigma from
    their step (its first loss ~0.09), so it stops after its first Adam step
    there; image 0's loss (~6) keeps it going. Each image's networks equal its
    single-image run's."""
    from pnpinversion_tpu_torch.schedulers.ddim import classifier_free_guidance, ddim_step

    _, tpipe, _, _, m0, *_ = setup
    a = _train_inputs(615, 2)
    unet, sched = tpipe.unet, tpipe.schedule
    t0, last = sched.timesteps[0], STEPS - 1
    with torch.no_grad():
        traj, maps = tinv.ddim_invert_with_maps(unet, sched, _t(a["traj"][:, 0]), _t(a["cond"]))
        traj = _t(a["traj"])
        m02 = {k: v.expand((2,) + v.shape[1:]).clone() for k, v in m0.items()}
        x = traj[1:, -1, 0]
        eps_u, _ = unet(x, t0, _t(a["uncond"][1:, 0]))
        eps_c, st = unet(x, t0, _t(a["cond"][1:, 0]), tctl.StyleTrainControl("all"),
                         {"sd_mapper_i": {k: v[1:] for k, v in m02.items()},
                          "img_tokens": _t(a["tokens"][1:])}, {}, 0)
        near = ddim_step(sched, classifier_free_guidance(eps_u, eps_c, 7.5), t0, x)[0]
        traj[1, last, 0] = near + 0.3 * _t(np.random.RandomState(617).randn(*near.shape))
        for k in maps:
            maps[k][1, last, 0] = st[k][0]
        eps_u2, _ = unet(traj[:, -1, 0], t0, _t(a["uncond"][:, 0]))
        first = tinv._losses(unet, sched, traj[:, -1], t0, 0, _t(a["cond"]), eps_u2[:, None],
                             traj[:, last], {k: v[:, last] for k, v in maps.items()},
                             _t(a["tokens"]), m02, 7.5, tctl.StyleTrainControl("all"))
        assert first[1] < 0.2 < 1.0 < 2.0 < first[0]

        def train(idx):
            return tinv.train_mappers(
                unet, sched, traj[idx], {k: v[idx] for k, v in maps.items()},
                _t(a["tokens"][idx]), _t(a["uncond"][idx]), _t(a["cond"][idx]), 7.5,
                {k: v[idx] for k, v in m02.items()}, num_inner_steps=INNER, epsilon=1.0)

        both = train([0, 1])
        for i in range(2):
            assert_networks_close({k: v[i : i + 1] for k, v in both.items()}, train([i]), unet,
                                  traj[i : i + 1, -1, 0], _t(a["cond"][i : i + 1, 0]),
                                  _t(a["tokens"][i : i + 1]), sched.timesteps, LOOP_RTOL)
        # at step 0 image 1 moved by one Adam step (about lr), image 0 by three
        moved = [(both["conv_end.kernel"][i, 0] - m02["conv_end.kernel"][i]).abs().max().item()
                 for i in range(2)]
        assert moved[1] < 1.5e-2 < 2e-2 < moved[0]


def test_editor_strip_matches_jax(setup):
    """Both editors on one image, the networks' start JAX's: [instruction |
    image | reconstruction | edit]."""
    _, _, _, ted, m0, img, strip = setup
    got = ted(ted_mod.METHOD, img, *PROMPTS, num_inner_steps=INNER, mapper0=m0)
    assert_strips_match(got, strip)
    with pytest.raises(NotImplementedError):
        ted("stylediffusion", img, *PROMPTS)


def test_batched_class_matches_single_editor(setup):
    """``BatchedStyleDiffusion`` on 2 images with a prompt pair each (one
    P2P spec) against the port's single-image editor, within 2 levels."""
    _, tpipe, _, ted, m0, *_ = setup
    imgs = seeded_images(616, 2)
    pairs = [PROMPTS, ("a big cat", "a red cat")]
    controls = [ted_mod.stylediffusion_p2p(tpipe, list(p)) for p in pairs]
    assert controls[0][0].spec == controls[1][0].spec
    cond_src = torch.stack([tpipe.encode_prompt([p[0]]) for p in pairs])
    cond2 = torch.stack([tpipe.encode_prompt(list(p)) for p in pairs])
    m02 = {k: v.expand((2,) + v.shape[1:]).clone() for k, v in m0.items()}
    recon, edit = BatchedStyleDiffusion(tpipe, ted.clip, num_inner_steps=INNER).edit_batch(
        controls[0][0].spec, imgs, cond_src, cond2, stack_tensors([t for _, t in controls]),
        mapper0=m02)
    for i in range(2):
        strip = ted(ted_mod.METHOD, imgs[i], *pairs[i], num_inner_steps=INNER, mapper0=m0)
        assert_panels_close(recon[i], strip[:, 32:48])
        assert_panels_close(edit[i], strip[:, 48:])
