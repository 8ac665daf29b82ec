"""The port's loading of local pipeline checkpoints against the JAX package's,
on the CPU at TINY in f32: HF directories written by the JAX package's
exporters from seeded weights (f32 and f16 safetensors, ``.bin`` files, the
older VAE attention names) and CompVis ``.ckpt`` files load to the same
modules in both packages; missing and stray keys are refused by name; the
safetensors reader and writer agree with the ``safetensors`` package byte
for byte."""
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import pipeline_params, rel_err
from pnpinversion_tpu.configs import TINY as JTINY
from pnpinversion_tpu.convert.export import export_clip_text, export_unet, export_vae
from pnpinversion_tpu.models.clip_text import clip_text_apply
from pnpinversion_tpu.models.unet import unet_apply
from pnpinversion_tpu.models.vae import vae_decode, vae_encode_moments
from pnpinversion_tpu.pipeline import SDPipeline as JaxPipeline
from pnpinversion_tpu_torch.configs import TINY
from pnpinversion_tpu_torch.convert import clip_text_state_dict, unet_state_dict, vae_state_dict
from pnpinversion_tpu_torch.convert import checkpoint as ck
from pnpinversion_tpu_torch.convert import ldm
from pnpinversion_tpu_torch.convert.safetensors_io import read_safetensors, write_safetensors
from pnpinversion_tpu_torch.pipeline import SDPipeline

RTOL = 1e-5  # of max, f32 on both sides, sums in other orders
# one JAX program each, compiled once for the four variants
_UNET = jax.jit(lambda p, x, c: unet_apply(p, x, jnp.int32(500), c, JTINY.unet))
_VAE = jax.jit(lambda p, i, z: (vae_encode_moments(p, i, JTINY.vae), vae_decode(p, z, JTINY.vae)))
_TEXT = jax.jit(lambda p, i: clip_text_apply(p, i, JTINY.text))
FILES = {"unet": "diffusion_pytorch_model", "vae": "diffusion_pytorch_model",
         "text_encoder": "model"}
OLD_VAE = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


def _exported(params) -> dict:
    return {"unet": export_unet(params["unet"], JTINY.unet),
            "vae": export_vae(params["vae"], JTINY.vae),
            "text_encoder": export_clip_text(params["text"], JTINY.text)}


def _write_hf(root: str, sds: dict, variant: str) -> str:
    from safetensors.numpy import save_file

    for sub, sd in sds.items():
        d = os.path.join(root, sub)
        os.makedirs(d, exist_ok=True)
        if variant == "old_vae" and sub == "vae":
            sd = {_old_vae_name(k): v for k, v in sd.items()}
        if variant == "bin":
            name = "pytorch_model" if sub == "text_encoder" else FILES[sub]
            torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                       os.path.join(d, f"{name}.bin"))
        else:
            dt = np.float16 if variant == "f16" else np.float32
            save_file({k: np.ascontiguousarray(v if v.dtype == np.int64 else v.astype(dt))
                       for k, v in sd.items()}, os.path.join(d, f"{FILES[sub]}.safetensors"))
    return root


def _old_vae_name(k: str) -> str:
    for new, old in OLD_VAE.items():
        if f".attentions.0.{new}." in k:
            return k.replace(f".attentions.0.{new}.", f".attentions.0.{old}.")
    return k


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """{variant: (JAX pipeline, port pipeline)} loaded from the same HF
    directory, and the seeded weights."""
    params = pipeline_params(JTINY, seed=11)
    sds = _exported(params)
    out = {}
    for variant in ("f32", "f16", "bin", "old_vae"):
        root = _write_hf(str(tmp_path_factory.mktemp(variant)), sds, variant)
        tpipe = SDPipeline.create(TINY, checkpoint_dir=root, device="cpu", dtype=torch.float32)
        jpipe = JaxPipeline.create(JTINY, checkpoint_dir=root)
        out[variant] = (jpipe, tpipe)
    return out, params


VARIANTS = ("f32", "f16", "bin", "old_vae")


@pytest.mark.parametrize("variant", VARIANTS)
def test_parameters_match_jax_bit_for_bit(loaded, variant):
    """Both packages hold the file's values, cast to f32 (bit for bit: f16
    values widen exactly), and the f32 files' values are the seeded ones."""
    (pipes, params) = loaded
    jpipe, tpipe = pipes[variant]
    jp = jax.tree.map(np.asarray, jpipe.params)
    for module, want in ((tpipe.unet, unet_state_dict(jp["unet"])),
                         (tpipe.vae, vae_state_dict(jp["vae"])),
                         (tpipe.text_encoder, clip_text_state_dict(jp["text"]))):
        got = module.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    if variant != "f16":
        seeded = unet_state_dict(params["unet"])
        got = tpipe.unet.state_dict()
        for k, v in seeded.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("variant", VARIANTS)
def test_unet_eps_matches_jax(loaded, variant):
    jpipe, tpipe = loaded[0][variant]
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    ctx = (rng.randn(2, 77, 32) * 0.5).astype(np.float32)
    want, _ = _UNET(jpipe.params["unet"], jnp.asarray(x), jnp.asarray(ctx))
    with torch.inference_mode():
        got, _ = tpipe.unet(torch.from_numpy(x), 500, torch.from_numpy(ctx))
    assert rel_err(got, want) <= RTOL


@pytest.mark.parametrize("variant", VARIANTS)
def test_vae_matches_jax(loaded, variant):
    jpipe, tpipe = loaded[0][variant]
    rng = np.random.RandomState(4)
    img = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    z = rng.randn(1, 8, 8, 4).astype(np.float32)
    (mean, logvar), dec = _VAE(jpipe.params["vae"], jnp.asarray(img), jnp.asarray(z))
    with torch.inference_mode():
        tmean, tlogvar = tpipe.vae.encode_moments(torch.from_numpy(img))
        tdec = tpipe.vae.decode(torch.from_numpy(z))
    for got, want in ((tmean, mean), (tlogvar, logvar), (tdec, dec)):
        assert rel_err(got, want) <= RTOL


@pytest.mark.parametrize("variant", VARIANTS)
def test_text_states_match_jax(loaded, variant):
    jpipe, tpipe = loaded[0][variant]
    ids = (np.arange(77, dtype=np.int32)[None] * 7) % JTINY.text.vocab_size
    want = _TEXT(jpipe.params["text"], jnp.asarray(ids))
    with torch.inference_mode():
        got = tpipe.text_encoder(torch.from_numpy(ids.astype(np.int64)))
    assert rel_err(got, want) <= RTOL


def _port_sds(seed: int = 11) -> dict:
    params = pipeline_params(JTINY, seed=seed)
    return {k: {n: torch.from_numpy(np.ascontiguousarray(v)) for n, v in sd.items()}
            for k, sd in _exported(params).items()}


@pytest.mark.parametrize("fault", ["missing", "stray"])
def test_a_missing_or_stray_key_is_refused_by_name(tmp_path, fault):
    sds = _port_sds()
    if fault == "missing":
        del sds["unet"]["down_blocks.0.resnets.0.conv1.weight"]
        name = "down_blocks.0.resnets.0.conv1.weight"
    else:
        sds["unet"]["surprise.weight"] = torch.zeros(3)
        name = "surprise.weight"
    for sub, sd in sds.items():
        os.makedirs(tmp_path / sub)
        write_safetensors(str(tmp_path / sub / "model.safetensors"), sd)
    with pytest.raises(KeyError, match=name.replace(".", r"\.")):
        SDPipeline.create(TINY, checkpoint_dir=str(tmp_path), device="cpu")


def test_wrong_shape_and_no_weights_are_refused(tmp_path):
    with pytest.raises(FileNotFoundError):
        SDPipeline.create(TINY, checkpoint_dir=str(tmp_path), device="cpu")
    sds = _port_sds()
    sds["vae"]["quant_conv.weight"] = torch.zeros(8, 8, 3, 3)
    for sub, sd in sds.items():
        os.makedirs(tmp_path / sub)
        write_safetensors(str(tmp_path / sub / "model.safetensors"), sd)
    with pytest.raises(ValueError, match="quant_conv.weight"):
        SDPipeline.create(TINY, checkpoint_dir=str(tmp_path), device="cpu")


def _write_ldm(path: str, sds: dict) -> None:
    """A CompVis .ckpt of the exported state dicts, renamed by the JAX convert
    CLI test's own helpers, with the training-time state a real one carries
    (which must be ignored), as that test's ``_make_ldm_ckpt`` writes it."""
    from test_convert_cli import _diffusers_unet_to_ldm, _diffusers_vae_to_ldm

    sd = {}
    for prefix, part in (("model.diffusion_model.", _diffusers_unet_to_ldm(sds["unet"])),
                         ("first_stage_model.", _diffusers_vae_to_ldm(sds["vae"])),
                         ("cond_stage_model.transformer.", sds["text_encoder"])):
        sd.update({prefix + k: v for k, v in part.items()})
    sd.update({"betas": np.zeros((8,), np.float32), "alphas_cumprod": np.ones((8,), np.float32),
               "model_ema.decay": np.asarray(0.999, np.float32)})
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)


@pytest.fixture(scope="module")
def ldm_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("ldm")
    _write_ldm(str(root / "ip2p.ckpt"), _exported(pipeline_params(JTINY, seed=11)))
    return str(root)


def _state(pipe):
    return {p: m.state_dict() for p, m in (("unet", pipe.unet), ("vae", pipe.vae),
                                           ("text", pipe.text_encoder))}


def test_ldm_ckpt_loads_the_hf_dirs_modules(loaded, ldm_dir):
    """The .ckpt of the same weights (with its training-time keys: betas,
    alphas_cumprod, model_ema.*) loads to the HF directory's modules, bit for
    bit, whether checkpoint_dir names its directory or the file."""
    want = _state(loaded[0]["f32"][1])
    for src in (ldm_dir, os.path.join(ldm_dir, "ip2p.ckpt")):
        got = _state(SDPipeline.create(TINY, checkpoint_dir=src, device="cpu"))
        for part in want:
            assert set(got[part]) == set(want[part])
            for k in want[part]:
                assert torch.equal(got[part][k], want[part][k]), (part, k)


def test_ldm_stray_key_is_refused(ldm_dir, tmp_path):
    sd = torch.load(os.path.join(ldm_dir, "ip2p.ckpt"), weights_only=True)["state_dict"]
    sd["surprise.weight"] = torch.zeros(3)
    torch.save({"state_dict": sd}, tmp_path / "bad.ckpt")
    with pytest.raises(ValueError, match="unrecognized LDM keys"):
        SDPipeline.create(TINY, checkpoint_dir=str(tmp_path), device="cpu")
    sd.pop("surprise.weight")
    sd["model.diffusion_model.surprise.weight"] = torch.zeros(3)
    torch.save({"state_dict": sd}, tmp_path / "bad.ckpt")
    with pytest.raises(KeyError, match="surprise"):
        SDPipeline.create(TINY, checkpoint_dir=str(tmp_path), device="cpu")


def test_eight_channel_ldm_round_trip(tmp_path):
    """The port's own CompVis writer (used by the smoke) and reader invert
    each other on InstructPix2Pix's 8-channel UNet."""
    import dataclasses

    cfg = dataclasses.replace(TINY, unet=dataclasses.replace(TINY.unet, in_channels=8))
    pipe = SDPipeline.create(cfg, seed=5, device="cpu")
    want = _state(pipe)
    torch.save({"state_dict": ldm.ldm_state_dict(want["unet"], want["vae"], want["text"], cfg),
                "betas": torch.zeros(4)}, tmp_path / "ip2p.ckpt")
    assert ck.checkpoint_in_channels(str(tmp_path)) == 8
    got = _state(SDPipeline.create(cfg, checkpoint_dir=str(tmp_path), device="cpu"))
    for part in want:
        for k in want[part]:
            assert torch.equal(got[part][k], want[part][k]), (part, k)


# --------------------------------------------------------------- safetensors
DTYPES = {"F32": (torch.float32, np.float32), "F16": (torch.float16, np.float16),
          "BF16": (torch.bfloat16, None), "I32": (torch.int32, np.int32),
          "I64": (torch.int64, np.int64)}


def _tensors(dtype: torch.dtype) -> dict:
    g = torch.Generator().manual_seed(0)
    base = {"b.weight": torch.randn(3, 5, generator=g), "a": torch.randn(7, generator=g) * 100,
            "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4)}
    out = {k: v.to(dtype) for k, v in base.items()}
    out["other"] = torch.randn(2, 2, generator=g)  # a second dtype orders the layout
    return out


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_safetensors_byte_for_byte(tmp_path, name):
    """The port's writer gives the package's bytes; each reads the other's
    file back to the same tensors."""
    from safetensors.torch import load_file, save_file

    tensors = _tensors(DTYPES[name][0])
    # one metadata key: the package writes several in its hash map's order
    for meta in (None, {"format": "pt"}):
        save_file(tensors, str(tmp_path / "theirs.safetensors"), metadata=meta)
        write_safetensors(str(tmp_path / "ours.safetensors"), tensors, meta)
        theirs = (tmp_path / "theirs.safetensors").read_bytes()
        assert (tmp_path / "ours.safetensors").read_bytes() == theirs
        got, got_meta = read_safetensors(str(tmp_path / "theirs.safetensors"),
                                         with_metadata=True)
        assert got_meta == (meta or {})
        back = load_file(str(tmp_path / "ours.safetensors"))
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
            assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def _raw_file(path, header: bytes, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header + data)


@pytest.mark.parametrize("fault,match", [
    (b'{"a":{"dtype":"F8_E4M3","shape":[2],"data_offsets":[0,2]}}', "dtype"),
    (b'{"a":{"dtype":"F32","shape":[4],"data_offsets":[0,16]}}', "outside"),
    (b'{"a":{"dtype":"F32","shape":[2],"data_offsets":[0,8]},'
     b'"b":{"dtype":"F32","shape":[1],"data_offsets":[4,8]}}', "overlap"),
    (b'{"a":{"dtype":"F32","shape":[3],"data_offsets":[0,8]}}', "needs"),
])
def test_safetensors_reader_refuses_a_bad_header(tmp_path, fault, match):
    _raw_file(tmp_path / "bad.safetensors", fault, bytes(8))
    with pytest.raises(ValueError, match=match):
        read_safetensors(str(tmp_path / "bad.safetensors"))


def test_convert_cli_checks_the_pipelines(ldm_dir, tmp_path, monkeypatch):
    """``python -m pnpinversion_tpu_torch.convert`` on a root holding an HF
    dir and an ip2p .ckpt (TINY configs through the same code path): every
    key consumed, every tensor filled, finite forward smokes, the manifest."""
    import json
    import shutil

    import pnpinversion_tpu_torch.convert.__main__ as cli

    root = tmp_path / "root"
    _write_hf(str(root), _exported(pipeline_params(JTINY, seed=11)), "f32")
    shutil.copy(os.path.join(ldm_dir, "ip2p.ckpt"), root / "ip2p.ckpt")
    monkeypatch.setattr(cli, "SD14", TINY)
    monkeypatch.setattr(cli, "IP2P", TINY)
    manifest = cli.main(["--root", str(root), "--device", "cpu"])
    models = manifest["models"]
    for name in ("sd14", "ip2p"):
        assert models[name]["layout"] == ("hf" if name == "sd14" else "ldm")
        for part in ("unet", "vae", "text"):
            rep = models[name][part]
            assert rep["keys_consumed"] + rep["keys_ignored"] == rep["keys_total"]
            assert rep["tensors_filled"] > 0 and np.isfinite(rep["forward"]["mean"])
    assert models["sd14"]["text"]["keys_ignored"] == 1  # position_ids
    assert "skipped" in models["sd21"] and "skipped" in models["instructdiffusion"]
    with open(root / "conversion_manifest.json") as f:
        assert json.load(f)["models"]["sd14"]["config"] == "tiny"
