"""The dtype each editor computes its UNet and VAE in, on a bf16 pipeline, in
the PyTorch port and in the JAX package, for every method family the port
has (TINY, 2 DDIM steps, on the CPU).

The JAX package's layers cast each weight to the dtype of the activation
they meet, so a JAX function that hands f32 activations to a bf16
pipeline's modules computes in f32 (edit-friendly DDPM's latents, made f32
by its f32 alphas; EDICT's; the instruction editors' f32 sigmas), and the
port must compute there in f32 as well (its layers cast the same way). The
JAX side is traced only: ``jax.jit`` becomes ``jax.eval_shape`` with zeros
for results, and its UNet and VAE record their input's dtype and return
zeros, so no JAX program is compiled. The port's side runs for real, bf16
on the CPU, with its UNet and VAE recording theirs."""
import collections
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import pipeline_params, rel_err, seeded_images, tiny_configs
from pnpinversion_tpu_torch.models.unet import UNet
from pnpinversion_tpu_torch.models.vae import VAE
from pnpinversion_tpu_torch.pipeline import SDPipeline

torch.set_num_threads(2)

STEPS = 2
PROMPTS = ("a cat on a mat", "a dog on a mat")
# (method, editor module (the same name in both packages), class, constructor keywords)
RUNS = [(m, "p2p_editor", "P2PEditor", {}) for m in (
    "directinversion+p2p", "ddim+p2p", "null-text-inversion+p2p",
    "negative-prompt-inversion+p2p", "negative-prompt-inversion+proximal-guidance",
    "null-text-inversion+proximal-guidance", "ablation_null-latent-inversion+p2p",
    "ablation_null-text-inversion_single_branch+p2p", "directinversion+p2p_guidance_25_75",
    "ablation_directinversion_04+p2p")] + [
    ("ddim+masactrl", "masactrl_editor", "MasaCtrlEditor", {}),
    ("directinversion+masactrl", "masactrl_editor", "MasaCtrlEditor", {}),
    ("ddim+pnp", "pnp_editor", "PnPEditor", {}),
    ("directinversion+pnp", "pnp_editor", "PnPEditor", {}),
    ("edit-friendly-inversion+p2p", "ef_editor", "EditFriendlyEditor", {}),
    ("edict+direct_forward", "edict_editor", "EDICTEditor", {}),
    ("edict+p2p", "edict_editor", "EDICTEditor", {"precision": "df64"}),
    ("instruct-pix2pix", "instruct_editor", "InstructEditor", {}),
    ("instruct-diffusion", "instruct_editor", "InstructEditor", {}),
    ("blended-latent-diffusion", "bld_editor", "BlendedLatentDiffusionEditor", {}),
    ("ddim+pix2pix-zero", "pix2pix_zero_editor", "Pix2PixZeroEditor", {}),
    ("directinversion+pix2pix-zero", "pix2pix_zero_editor", "Pix2PixZeroEditor", {}),
    ("stylediffusion+p2p", "stylediffusion_editor", "StyleDiffusionEditor", {}),
]
# the JAX editors imported before any test patches the functions they import
# by name (an editor first imported under a patch would keep the patch)
for _module in {r[1] for r in RUNS}:
    importlib.import_module(f"pnpinversion_tpu.editors.{_module}")
# StyleDiffusion's CLIP tower at TINY: its width is the UNet's context width
TINY_CLIP = dict(image_size=16, patch_size=8, width=32, layers=1, heads=2, projection_dim=16)
# the modules of the JAX package that call its UNet by name
JAX_UNET_CALLERS = ("inversion.ddim_inversion", "sampling.p2p_forward", "inversion.ef_ddpm",
                    "editors.pnp_editor", "editors.edict_editor", "editors.instruct_editor",
                    "editors.bld_editor", "inversion.pix2pix_zero", "inversion.stylediffusion")


@functools.lru_cache(maxsize=None)
def _zero_params(in_channels):
    """bf16 zeros in the JAX TINY pipeline's tree (only shapes and dtypes
    reach the traced programs), made once per UNet input width."""
    jcfg, _ = tiny_configs(in_channels)
    return jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.bfloat16), pipeline_params(jcfg, seed=0))


def _jax_dtypes(method, module, cls, kw):
    """{"unet", "encode", "decode"} -> the dtypes the JAX editor's programs
    hand its UNet and VAE, traced on a bf16 TINY pipeline."""
    from pnpinversion_tpu.pipeline import SDPipeline as JaxSDPipeline
    from pnpinversion_tpu.schedulers.ddim import make_ddim_schedule
    from pnpinversion_tpu.utils.tokenizer import default_tokenizer

    seen = collections.defaultdict(set)

    def unet_apply(params, x, t, context, config, control=None, tensors=None, state=None,
                   step=None):
        seen["unet"].add(str(x.dtype))
        return jnp.zeros(x.shape[:-1] + (config.out_channels,), x.dtype), state or {}

    def vae_encode(params, image, config, rng=None, scale=True):
        seen["encode"].add(str(image.dtype))
        b, h, w, _ = image.shape
        f = 2 ** (len(config.block_out_channels) - 1)
        return jnp.zeros((b, h // f, w // f, config.latent_channels), image.dtype)

    def vae_decode(params, latents, config, scale=True):
        seen["decode"].add(str(latents.dtype))
        f = 2 ** (len(config.block_out_channels) - 1)
        b, h, w, _ = latents.shape
        return jnp.zeros((b, h * f, w * f, 3), latents.dtype)

    def traced_jit(fn, **_):
        def run(*args, **kwargs):
            out = jax.eval_shape(fn, *args, **kwargs)
            return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), out)
        return run

    jcfg, _ = tiny_configs(8 if module == "instruct_editor" else 4)
    params = _zero_params(jcfg.unet.in_channels)
    pipe = JaxSDPipeline(config=jcfg, params=params, tokenizer=default_tokenizer(),
                         schedule=make_ddim_schedule(STEPS), dtype=jnp.bfloat16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", traced_jit)
        for name in JAX_UNET_CALLERS:
            mp.setattr(importlib.import_module(f"pnpinversion_tpu.{name}"), "unet_apply",
                       unet_apply)
        vae = importlib.import_module("pnpinversion_tpu.models.vae")
        mp.setattr(vae, "vae_encode", vae_encode)
        mp.setattr(vae, "vae_decode", vae_decode)
        for name in ("instruct_editor", "pix2pix_zero_editor"):
            mp.setattr(importlib.import_module(f"pnpinversion_tpu.editors.{name}"), "vae_encode",
                       vae_encode)
        editor = getattr(importlib.import_module(f"pnpinversion_tpu.editors.{module}"), cls)
        if module == "stylediffusion_editor":
            from pnpinversion_tpu.models import vit

            cfg = vit.ViTConfig(**TINY_CLIP)
            shapes = jax.eval_shape(lambda k: vit.init_vit_params(k, cfg), jax.random.PRNGKey(0))
            kw = dict(kw, clip_vision_params=jax.tree.map(
                lambda x: jnp.zeros(x.shape, x.dtype), shapes), clip_vision_cfg=cfg)
        _call(editor(pipe, **kw), method)
    return dict(seen)


def _torch_dtypes(method, module, cls, kw):
    """The same for the port's editor, run in bf16 on the CPU."""
    seen = collections.defaultdict(set)
    forward, encode, decode = UNet.forward, VAE.encode, VAE.decode

    def unet_forward(self, x, *args, **kwargs):
        seen["unet"].add(str(x.dtype).replace("torch.", ""))
        return forward(self, x, *args, **kwargs)

    def vae_encode(self, image, *args, **kwargs):
        seen["encode"].add(str(image.dtype).replace("torch.", ""))
        return encode(self, image, *args, **kwargs)

    def vae_decode(self, latents):
        seen["decode"].add(str(latents.dtype).replace("torch.", ""))
        return decode(self, latents)

    _, tcfg = tiny_configs(8 if module == "instruct_editor" else 4)
    pipe = SDPipeline.create(tcfg, num_ddim_steps=STEPS, device="cpu", dtype=torch.bfloat16)
    editor = getattr(importlib.import_module(f"pnpinversion_tpu_torch.editors.{module}"), cls)
    if module == "stylediffusion_editor":
        from pnpinversion_tpu_torch.models.vit import ViTConfig

        kw = dict(kw, clip_vision_cfg=ViTConfig(**TINY_CLIP))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(UNet, "forward", unet_forward)
        mp.setattr(VAE, "encode", vae_encode)
        mp.setattr(VAE, "decode", vae_decode)
        strip = _call(editor(pipe, **kw), method)
    assert strip.shape == (16, 64, 3) and strip.dtype == np.uint8
    return dict(seen)


def _call(editor, method):
    img = seeded_images(141, 1)[0]
    if method.startswith("instruct"):
        return editor(method, img, "make it a dog", steps=STEPS)
    if method.startswith("edit-friendly"):
        return editor(method, img, *PROMPTS, skip=1)
    if method == "blended-latent-diffusion":
        mask = np.zeros((16, 16), np.float32)
        mask[4:12, 2:10] = 1.0
        return editor(method, img, mask, PROMPTS[1])
    if method.endswith("pix2pix-zero"):
        return editor(method, img, *PROMPTS, caption="a cat")
    if method.startswith("stylediffusion"):
        return editor(method, img, *PROMPTS, num_inner_steps=2)
    return editor(method, img, *PROMPTS)


@pytest.mark.parametrize("method,module,cls,kw", RUNS, ids=[r[0] for r in RUNS])
def test_port_computes_in_the_dtypes_jax_does(method, module, cls, kw):
    """The UNet's, the VAE encoder's and the VAE decoder's input dtypes, as
    sets over the edit: bf16 throughout for the P2P, MasaCtrl, PnP, BLD (its
    blended carry), pix2pix-zero (its inverse step computed in f32 and cast
    back, its SGD step on the bf16 latent) and StyleDiffusion families; an f32 UNet and decode for EF (its encode bf16), EDICT (its
    encode f32 too) and the instruction editors (encode bf16)."""
    want = _jax_dtypes(method, module, cls, kw)
    assert _torch_dtypes(method, module, cls, kw) == want
    f32 = module in ("ef_editor", "edict_editor", "instruct_editor")
    assert want["unet"] == want["decode"] == {"float32" if f32 else "bfloat16"}


def test_f32_steps_of_the_bf16_families():
    """The f32 pieces inside the bf16 families, as the JAX package computes
    them: pix2pix-zero's inverse step (f32 from bf16 inputs, cast back by the
    inversion), StyleDiffusion's training loss (f32 on bf16 eps and maps) and
    its mapped V context (f32 from a bf16 context and f32 networks)."""
    from pnpinversion_tpu.inversion import pix2pix_zero as jp2z
    from pnpinversion_tpu.models import stylediffusion as jsd
    from pnpinversion_tpu.schedulers.ddim import make_ddim_schedule as jmake
    from pnpinversion_tpu_torch.control.stylediffusion import StyleTrainControl
    from pnpinversion_tpu_torch.inversion import pix2pix_zero as tp2z
    from pnpinversion_tpu_torch.inversion import stylediffusion as tinv
    from pnpinversion_tpu_torch.models import stylediffusion as tsd
    from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule

    x = jnp.zeros((1, 8, 8, 4), jnp.bfloat16)
    want = jax.eval_shape(lambda e, s: jp2z.p2z_inverse_step(jmake(2, steps_offset=1), e, 1, s),
                          x, x)
    got = tp2z.p2z_inverse_step(make_ddim_schedule(2, steps_offset=1),
                                torch.zeros((1, 8, 8, 4), dtype=torch.bfloat16), 1,
                                torch.zeros((1, 8, 8, 4), dtype=torch.bfloat16))
    assert str(want.dtype) == str(got.dtype).replace("torch.", "") == "float32"

    _, tcfg = tiny_configs()
    pipe = SDPipeline.create(tcfg, num_ddim_steps=STEPS, device="cpu", dtype=torch.bfloat16)
    m0 = {k: v[:, 0] for k, v in tsd.init_mapper_params(torch.Generator().manual_seed(0), 1, 1,
                                                       tokens_in=5).items()}
    lat = torch.zeros((1, 1, 8, 8, 4), dtype=torch.bfloat16)
    cond = torch.zeros((1, 1, 77, 32), dtype=torch.bfloat16)
    tokens = torch.ones((1, 5, 32))
    with torch.no_grad():
        loss = tinv._losses(pipe.unet, pipe.schedule, lat, 501, 0, cond, lat, lat, {}, tokens, m0,
                            7.5, StyleTrainControl("all"))
    assert loss.dtype == torch.float32
    jemb = jax.eval_shape(
        lambda c, t: jsd.forward_embed(jsd.mapper_at_step(jsd.init_mapper_params(
            jax.random.PRNGKey(0), 1, tokens_in=5, width=32), 0), c, t),
        jax.ShapeDtypeStruct((1, 77, 32), jnp.bfloat16), jax.ShapeDtypeStruct((1, 5, 32),
                                                                              jnp.float32))
    temb = tsd.forward_embed(m0, cond[:, None][:, :, 0], tokens)
    assert str(jemb.dtype) == str(temb.dtype).replace("torch.", "") == "float32"


def test_trainer_dtypes_match_jax():
    """The training step's dtypes at bf16 compute, as the JAX trainer has
    them (its loss traced with ``value_and_grad`` under ``eval_shape``, the
    port's step run for real on the CPU): the VAE, the text tower and the
    UNet see bf16; the loss is f32; the gradients reach the f32 masters in
    f32; the EMA and Adam's moments are f32. The UNet's noisy latent is the
    f32 ``q_sample`` rounded to bf16 once (checked bit for bit)."""
    import types

    from pnpinversion_tpu.training import trainer as jtr
    from pnpinversion_tpu_torch.models.clip_text import CLIPTextModel
    from pnpinversion_tpu_torch.training import trainer as tr

    jseen, seen = collections.defaultdict(set), collections.defaultdict(set)
    jcfg, tcfg = tiny_configs(8)

    def moments(params, image, config):
        jseen["encode"].add(str(image.dtype))
        b, h, w, _ = image.shape
        z = jnp.zeros((b, h // 2, w // 2, 4), image.dtype)
        return z, z

    def text(params, ids, config, dtype=jnp.float32):
        jseen["text"].add(jnp.dtype(dtype).name)
        return jnp.zeros(ids.shape + (config.width,), dtype)

    def unet(params, x, t, context, config, **_):
        jseen["unet"].add(str(x.dtype))
        return x[..., :4] * params["conv_in"]["kernel"][0, 0, 0, 0].astype(x.dtype), {}

    f32 = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), pipeline_params(jcfg, seed=0))
    fake = types.SimpleNamespace(cfg=jtr.TrainConfig(dtype=jnp.bfloat16), config=jcfg,
                                 null_ids=jnp.zeros((77,), jnp.int32),
                                 schedule_acp=np.full((1000,), 0.5, np.float32))
    imgs = jnp.zeros((2, 16, 16, 3), jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "vae_encode_moments", moments)
        mp.setattr(jtr, "clip_text_apply", text)
        mp.setattr(jtr, "unet_apply", unet)
        loss, grads = jax.eval_shape(jax.value_and_grad(
            lambda p: jtr.EditTrainer._microbatch_loss(
                fake, p, {"vae": f32["vae"], "text": f32["text"]}, imgs, imgs,
                jnp.zeros((2, 77), jnp.int32), jax.random.PRNGKey(0))), f32["unet"])
    jseen["loss"].add(str(loss.dtype))
    jseen["grads"] |= {str(g.dtype) for g in jax.tree.leaves(grads)}

    pipe = SDPipeline.create(tcfg, num_ddim_steps=STEPS, device="cpu", dtype=torch.bfloat16)
    trainer = tr.EditTrainer(tcfg, {"vae": pipe.vae, "text": pipe.text_encoder}, pipe.unet,
                             tr.TrainConfig(accum=1, dtype=torch.bfloat16), 2,
                             pipe.tokenize([""])[0])
    forward, encode, text_fwd, norm = UNet.forward, VAE.encode, CLIPTextModel.forward, tr.global_norm
    calls = {}
    name = lambda dt: str(dt).replace("torch.", "")

    def unet_forward(self, x, *args, **kwargs):
        seen["unet"].add(name(x.dtype))
        calls["x_in"] = x.detach()
        return forward(self, x, *args, **kwargs)

    def vae_encode(self, image, *args, **kwargs):
        seen["encode"].add(name(image.dtype))
        out = encode(self, image, *args, **kwargs)
        calls.setdefault("z", out)
        return out

    def text_forward(self, ids, dtype=torch.float32):
        seen["text"].add(name(dtype))
        return text_fwd(self, ids, dtype=dtype)

    def grad_norm(tensors):
        seen["grads"] |= {name(g.dtype) for g in tensors}
        return norm(tensors)

    rng = np.random.RandomState(4)
    batch = {"edited": rng.uniform(-1, 1, (1, 2, 16, 16, 3)).astype(np.float32),
             "cond_image": rng.uniform(-1, 1, (1, 2, 16, 16, 3)).astype(np.float32),
             "ids": pipe.tokenize(["make it red", "add a hat"])[None]}
    draws = trainer.draw(2, 16, torch.Generator().manual_seed(0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(UNet, "forward", unet_forward)
        mp.setattr(VAE, "encode", vae_encode)
        mp.setattr(CLIPTextModel, "forward", text_forward)
        mp.setattr(tr, "global_norm", grad_norm)
        m = trainer.train_step(batch, draws=[draws])
    seen["loss"].add(name(m["loss"].dtype))
    assert dict(seen) == dict(jseen)
    assert jseen["unet"] == jseen["encode"] == jseen["text"] == {"bfloat16"}
    assert jseen["loss"] == jseen["grads"] == {"float32"}
    state = trainer.state_dict()
    assert {p.dtype for part in ("params", "ema", "mu", "nu")
            for p in state[part].values()} == {torch.float32}
    a = trainer.acp[draws["t"]][:, None, None, None]
    want = (torch.sqrt(a) * calls["z"].float()
            + torch.sqrt(1.0 - a) * draws["noise"].to(torch.bfloat16).float()).to(torch.bfloat16)
    assert torch.equal(calls["x_in"][..., :4], want)


@pytest.mark.parametrize("weights,compute", [("bfloat16", "float32"), ("float32", "bfloat16")])
def test_text_tower_computes_in_the_dtype_asked(weights, compute):
    """The text tower returns (and computes in) the dtype asked for whatever
    its weights' dtype, as the JAX package's ``clip_text_apply`` casts each
    kernel to the activation's dtype: the JAX trainer encodes in its compute
    dtype on a pipeline of another. A bf16 tower asked for f32 raised before
    (its projections were plain ``nn.Linear``)."""
    from pnpinversion_tpu.models.clip_text import clip_text_apply
    from pnpinversion_tpu_torch.convert import from_jax_params

    jcfg, tcfg = tiny_configs()
    tree = pipeline_params(jcfg, seed=3)["text"]
    ids = np.random.RandomState(0).randint(0, 128, (2, 77)).astype(np.int32)
    jw, jc = getattr(jnp, weights), getattr(jnp, compute)
    want = clip_text_apply(jax.tree.map(lambda x: jnp.asarray(x, jw), tree), jnp.asarray(ids),
                           jcfg.text, dtype=jc)
    module = from_jax_params(tree, tcfg.text).to(getattr(torch, weights))
    with torch.no_grad():
        got = module(torch.as_tensor(ids).long(), dtype=getattr(torch, compute))
    assert str(got.dtype).replace("torch.", "") == str(want.dtype) == compute
    tol = 1e-5 if compute == "float32" else 5e-2  # bf16 rounding of every layer otherwise
    assert rel_err(got, np.asarray(want.astype(jnp.float32))) <= tol
