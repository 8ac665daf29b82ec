"""UNet, CLIP text encoder and VAE of the PyTorch port vs the JAX package at
TINY, f32 on the CPU, with the same numpy weights and inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import numpy_params, rel_err
from pnpinversion_tpu.configs import TINY as JTINY
from pnpinversion_tpu.control.p2p import P2PControl as JaxP2PControl
from pnpinversion_tpu.control.p2p import make_p2p_control as jax_make_p2p_control
from pnpinversion_tpu.models.clip_text import clip_text_apply, init_clip_text_params
from pnpinversion_tpu.models.unet import init_unet_params, unet_apply
from pnpinversion_tpu.models.vae import (
    image_to_latent,
    init_vae_params,
    latent_to_image,
    vae_decode,
)
from pnpinversion_tpu.utils.tokenizer import SimpleWordTokenizer as JaxTokenizer
from pnpinversion_tpu_torch.configs import TINY
from pnpinversion_tpu_torch.control.p2p import P2PControl, make_p2p_control
from pnpinversion_tpu_torch.convert import from_jax_params
from pnpinversion_tpu_torch.models import unet as tunet
from pnpinversion_tpu_torch.models import vae as tvae
from pnpinversion_tpu_torch.pipeline import SDPipeline
from pnpinversion_tpu_torch.utils.tokenizer import default_tokenizer

# f32 on both sides with the same formulas; differences are summation order,
# compounded through the network's depth. Relative to max |reference|.
RTOL = 1e-4
SRC, TAR = "a cat on a mat", "a silver cat on a mat"


@pytest.fixture(scope="module")
def unet_pair():
    params = numpy_params(init_unet_params, JTINY.unet, seed=1)
    return jax.tree.map(jnp.asarray, params), from_jax_params(params, TINY.unet)


def test_unet_sites_match(unet_pair):
    from pnpinversion_tpu.models.unet import enumerate_sites

    assert [tuple(dataclasses.astuple(s) for s in pair)
            for pair in tunet.enumerate_sites(TINY.unet)] == [
        tuple(dataclasses.astuple(s) for s in pair) for pair in enumerate_sites(JTINY.unet)]


def test_unet_no_control(unet_pair):
    jparams, module = unet_pair
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    want, _ = jax.jit(lambda p, x, c: unet_apply(p, x, jnp.asarray(741), c, JTINY.unet))(
        jparams, jnp.asarray(x), jnp.asarray(ctx))
    with torch.inference_mode():
        got, state = module(torch.from_numpy(x), 741, torch.from_numpy(ctx))
    assert state == {}
    assert rel_err(got, want) <= RTOL


@pytest.mark.parametrize("step,tar,replace", [(1, TAR, False), (3, TAR, False),
                                              (1, "a dog on a mat", True)])
def test_unet_srcfree_p2p_control(unet_pair, step, tar, replace):
    """The fused scan's (2B-1)-row call under P2P refine (or replace) +
    LocalBlend + reweight: step 1 is inside the cross/self replace windows,
    step 3 outside. The LocalBlend map store must match too."""
    jparams, module = unet_pair
    rng = np.random.RandomState(step)
    word = tar.split()[1]
    kw = dict(num_steps=4, blend_words=(("cat",), (word,)),
              eq_params={"words": (word,), "values": (2.0,)},
              is_replace_controller=replace,
              num_lb_slots=tunet.num_lb_slots(TINY.unet),
              lb_res=tunet.lb_resolution(TINY.unet), latent_size=8)
    jctrl, jtensors = jax_make_p2p_control([SRC, tar], JaxTokenizer(), **kw)
    tctrl, ttensors = make_p2p_control([SRC, tar], default_tokenizer(), **kw)
    jctrl = JaxP2PControl(dataclasses.replace(jctrl.spec, uncond_rows=1))
    tctrl = P2PControl(dataclasses.replace(tctrl.spec, uncond_rows=1))

    x = rng.randn(3, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(3, 77, 32).astype(np.float32)
    lb0 = rng.rand(*jctrl.init_state(2, heads=2)["lb_maps"].shape).astype(np.float32)

    def jfn(p, x, c, tensors, lb, step):
        return unet_apply(p, x, jnp.asarray(481), c, JTINY.unet, jctrl, tensors,
                          {"lb_maps": lb}, step)

    want, wstate = jax.jit(jfn)(jparams, jnp.asarray(x), jnp.asarray(ctx), jtensors,
                                jnp.asarray(lb0), jnp.asarray(step))
    with torch.inference_mode():
        got, gstate = module(torch.from_numpy(x), 481, torch.from_numpy(ctx), tctrl, ttensors,
                             {"lb_maps": torch.from_numpy(lb0.copy())}, step)
    assert rel_err(got, want) <= RTOL
    assert rel_err(gstate["lb_maps"], wstate["lb_maps"]) <= RTOL


def test_clip_text():
    params = numpy_params(init_clip_text_params, JTINY.text, seed=2)
    module = from_jax_params(params, TINY.text)
    jt, tt = JaxTokenizer(), default_tokenizer()
    prompts = [SRC, TAR, ""]
    jids = np.asarray(jt(prompts, max_length=77)["input_ids"], np.int32)
    tids = torch.as_tensor(tt(prompts, max_length=77)["input_ids"])
    np.testing.assert_array_equal(tids.numpy(), jids)
    want = jax.jit(lambda p, i: clip_text_apply(p, i, JTINY.text))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(jids))
    with torch.inference_mode():
        got = module(tids)
    assert rel_err(got, want) <= RTOL


@pytest.fixture(scope="module")
def vae_pair():
    params = numpy_params(init_vae_params, JTINY.vae, seed=3)
    return jax.tree.map(jnp.asarray, params), from_jax_params(params, TINY.vae)


def test_vae_encode(vae_pair):
    jparams, module = vae_pair
    img = (np.random.RandomState(4).rand(16, 16, 3) * 255).astype(np.uint8)
    want = jax.jit(lambda p, i: image_to_latent(p, i, JTINY.vae))(jparams, jnp.asarray(img))
    with torch.inference_mode():
        got = tvae.image_to_latent(module, torch.from_numpy(img))
    assert got.shape == (1, 8, 8, 4)
    assert rel_err(got, want) <= RTOL


def test_vae_decode(vae_pair):
    jparams, module = vae_pair
    z = np.random.RandomState(5).randn(2, 8, 8, 4).astype(np.float32)
    want_f, want_u8 = jax.jit(lambda p, z: (vae_decode(p, z, JTINY.vae),
                                            latent_to_image(p, z, JTINY.vae)))(
        jparams, jnp.asarray(z))
    with torch.inference_mode():
        got_f = module.decode(torch.from_numpy(z))
        got_u8 = tvae.latent_to_image(module, torch.from_numpy(z))
    assert rel_err(got_f, want_f) <= RTOL
    # truncation to uint8 flips a value where f32 noise straddles an integer
    diff = np.abs(got_u8.numpy().astype(int) - np.asarray(want_u8).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_random_pipeline_on_cpu():
    """create() draws the JAX package's init distributions; every float
    parameter is in the pipeline dtype."""
    pipe = SDPipeline.create(TINY, seed=3, num_ddim_steps=4, device="cpu")
    assert pipe.device.type == "cpu" and pipe.dtype == torch.float32
    w = pipe.unet.conv_in.weight
    bound = 1.0 / np.sqrt(w[0].numel())
    assert w.abs().max().item() <= bound and w.std().item() > bound / 3
    assert torch.all(pipe.unet.conv_norm_out.weight == 1)
    assert torch.all(pipe.unet.conv_in.bias == 0)
    emb = pipe.text_encoder.text_model.embeddings.token_embedding.weight
    assert abs(emb.std().item() - 0.02) < 0.005
    assert all(p.dtype == torch.float32 for m in (pipe.unet, pipe.vae, pipe.text_encoder)
               for p in m.parameters())


def test_create_without_device_needs_cuda():
    """Entry points run on CUDA unless asked for the CPU; they never fall
    back to it quietly."""
    if torch.cuda.is_available():
        assert SDPipeline.create(TINY, num_ddim_steps=4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SDPipeline.create(TINY, num_ddim_steps=4)
