"""Local checkpoints -> the port's modules (the counterpart of the JAX
package's ``convert/checkpoint.py``).

The port reads the *source* layout that the JAX convert CLI takes in (its
``--root``), not the orbax caches that CLI writes for the JAX runtime:

    <checkpoint_dir>/
      unet/ vae/ text_encoder/ [tokenizer/]  an HF pipeline (SD1.4, SD2.1)
      or one CompVis *.ckpt                  InstructPix2Pix / InstructDiffusion
      clip/ dino/ lpips/                     the evaluator's metric models
      blip/ blip_tokenizer/vocab.txt         pix2pix-zero's captioner

Every load is strict (``state_dict.load_strict``): a missing or unexpected
key raises, and no module keeps a random weight. There is no cache: the
files are read each time, cast to the asked dtype as they load.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from pnpinversion_tpu_torch.configs import CLIPTextConfig, StableDiffusionConfig
from pnpinversion_tpu_torch.convert import ldm, metric_models as mm
from pnpinversion_tpu_torch.convert.state_dict import (
    load_pipeline_part,
    load_strict,
    read_state_dict,
)
from pnpinversion_tpu_torch.models.clip_text import CLIPTextModel
from pnpinversion_tpu_torch.models.unet import UNet
from pnpinversion_tpu_torch.models.vae import VAE
from pnpinversion_tpu_torch.models.vit import ViT, ViTConfig

HF_PARTS = {"unet": "unet", "vae": "vae", "text": "text_encoder"}


def find_pipeline_source(checkpoint_dir: str) -> Tuple[str, str]:
    """("hf", dir) for an HF pipeline directory (it has ``unet/``), ("ldm",
    path) for a CompVis ``.ckpt`` file or a directory holding exactly one."""
    if os.path.isfile(checkpoint_dir) and checkpoint_dir.endswith(".ckpt"):
        return "ldm", checkpoint_dir
    if os.path.isdir(os.path.join(checkpoint_dir, "unet")):
        return "hf", checkpoint_dir
    if os.path.isdir(checkpoint_dir):
        ckpts = sorted(f for f in os.listdir(checkpoint_dir) if f.endswith(".ckpt"))
        if len(ckpts) == 1:
            return "ldm", os.path.join(checkpoint_dir, ckpts[0])
        if ckpts:
            raise ValueError(f"{checkpoint_dir} holds {len(ckpts)} .ckpt files {ckpts}: "
                             "pass the one to load")
    raise FileNotFoundError(f"no pipeline weights at {checkpoint_dir}: want an HF directory "
                            "(unet/ vae/ text_encoder/) or a CompVis .ckpt")


def pipeline_state_dicts(checkpoint_dir: str,
                         config: StableDiffusionConfig) -> Tuple[Tuple[str, str], dict]:
    """((kind, path), {unet, vae, text} state dicts in the diffusers /
    transformers layout) of a pipeline checkpoint."""
    kind, path = find_pipeline_source(checkpoint_dir)
    if kind == "hf":
        sds = {part: read_state_dict(os.path.join(path, sub)) for part, sub in HF_PARTS.items()}
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        sds = ldm.ldm_to_diffusers(raw.get("state_dict", raw), config)
    return (kind, path), sds


def checkpoint_in_channels(checkpoint_dir: str) -> int:
    """The input channels of a pipeline checkpoint's UNet (4 for SD, 8 for
    InstructPix2Pix's): the second axis of its ``conv_in`` weight."""
    kind, path = find_pipeline_source(checkpoint_dir)
    if kind == "hf":
        sd = read_state_dict(os.path.join(path, "unet"))
        return int(sd["conv_in.weight"].shape[1])
    raw = torch.load(path, map_location="cpu", weights_only=True)
    return int(raw.get("state_dict", raw)[ldm.UNET_PREFIX + "input_blocks.0.0.weight"].shape[1])


def empty_pipeline_modules(config: StableDiffusionConfig) -> Dict[str, torch.nn.Module]:
    with torch.device("meta"):
        return {"unet": UNet(config.unet), "vae": VAE(config.vae),
                "text": CLIPTextModel(config.text)}


def load_pipeline_modules(checkpoint_dir: str, config: StableDiffusionConfig,
                          dtype: torch.dtype = torch.float32, device="cpu", tokenizer=None):
    """({unet, vae, text} modules, tokenizer) of a pipeline checkpoint: the
    CLIP BPE tokenizer of ``<dir>/tokenizer`` where there is one, else the
    word tokenizer (the JAX ``load_pipeline_params``' rule)."""
    from pnpinversion_tpu_torch.utils.tokenizer import default_tokenizer

    (_, path), sds = pipeline_state_dicts(checkpoint_dir, config)
    modules = {part: load_pipeline_part(m, part, sds[part], dtype, device, what=f"{path} {part}")
               for part, m in empty_pipeline_modules(config).items()}
    if tokenizer is None:
        root = checkpoint_dir if os.path.isdir(checkpoint_dir) else os.path.dirname(path)
        tok_dir = os.path.join(root, "tokenizer")
        tokenizer = default_tokenizer(tok_dir if os.path.isdir(tok_dir) else None)
    return modules, tokenizer


def _load(module_fn, sd: dict, dtype, device, what: str) -> torch.nn.Module:
    with torch.device("meta"):
        module = module_fn()
    return load_strict(module, sd, dtype, device, what=what)


def load_clip_modules(clip_dir: str, vision: ViTConfig, text: CLIPTextConfig,
                      device="cpu", dtype=torch.float32) -> Dict[str, torch.nn.Module]:
    """``clip_vision``, ``clip_text`` and ``clip_text_proj`` of a transformers
    CLIPModel directory; every key consumed."""
    sd = mm.TrackingDict(read_state_dict(clip_dir))
    vis = mm.clip_vision_state_dict(sd, vision.layers)
    txt = mm.clip_text_tower(sd)
    proj = {"weight": sd["text_projection.weight"]}
    mm.check_consumed(sd, clip_dir)
    proj_out, width = proj["weight"].shape
    return {"clip_vision": _load(lambda: ViT(vision), vis, dtype, device, f"{clip_dir} vision"),
            "clip_text": _load(lambda: CLIPTextModel(text), txt, dtype, device,
                               f"{clip_dir} text"),
            "clip_text_proj": _load(lambda: torch.nn.Linear(width, proj_out, bias=False), proj,
                                    dtype, device, f"{clip_dir} text_projection")}


def load_dino_module(dino_dir: str, config: ViTConfig, device="cpu",
                     dtype=torch.float32) -> ViT:
    """DINO's ViT from a timm-style directory; every key consumed."""
    sd = mm.TrackingDict(read_state_dict(dino_dir))
    vit_sd = mm.timm_vit_state_dict(sd, config.layers)
    mm.check_consumed(sd, dino_dir)
    return _load(lambda: ViT(config), vit_sd, dtype, device, dino_dir)


def load_lpips_module(lpips_dir: str, device="cpu", dtype=torch.float32) -> torch.nn.Module:
    """LPIPS-squeeze from a directory of the backbone's and the heads'
    weights; every key consumed."""
    from pnpinversion_tpu_torch.models.lpips import LPIPS

    sd = mm.TrackingDict(read_state_dict(lpips_dir))
    lp = mm.lpips_state_dict(sd)
    mm.check_consumed(sd, lpips_dir)
    return _load(LPIPS, lp, dtype, device, lpips_dir)


def load_metric_modules(checkpoint_dir: str, clip_vision: ViTConfig, clip_text: CLIPTextConfig,
                        dino: ViTConfig, device="cpu",
                        dtype=torch.float32) -> Dict[str, torch.nn.Module]:
    """The metric models found under ``checkpoint_dir`` (``clip/``,
    ``dino/``, ``lpips/``), by the ``MetricsCalculator``'s names; a missing
    directory is skipped, as the JAX ``load_metric_params`` skips a missing
    cache."""
    out: Dict[str, torch.nn.Module] = {}
    clip_dir, dino_dir, lpips_dir = (os.path.join(checkpoint_dir, n)
                                     for n in ("clip", "dino", "lpips"))
    if os.path.isdir(clip_dir):
        out.update(load_clip_modules(clip_dir, clip_vision, clip_text, device, dtype))
    if os.path.isdir(dino_dir):
        out["dino"] = load_dino_module(dino_dir, dino, device, dtype)
    if os.path.isdir(lpips_dir):
        out["lpips"] = load_lpips_module(lpips_dir, device, dtype)
    return out


def load_blip_modules(blip_dir: str, vision: ViTConfig, text, device="cpu",
                      dtype=torch.float32) -> Tuple[ViT, torch.nn.Module]:
    """(vision tower, text decoder) of a BLIP directory (lavis layout:
    ``visual_encoder.*`` and ``text_decoder.*``); every key of its files
    consumed."""
    from pnpinversion_tpu_torch.models.blip import BlipTextDecoder

    sd = mm.TrackingDict(read_state_dict(blip_dir))
    vis = mm.timm_vit_state_dict(sd, vision.layers, prefix="visual_encoder.")
    dec = mm.blip_decoder_state_dict(sd, text.layers)
    mm.check_consumed(sd, blip_dir)
    return (_load(lambda: ViT(vision), vis, dtype, device, f"{blip_dir} vision"),
            _load(lambda: BlipTextDecoder(text), dec, dtype, device, f"{blip_dir} decoder"))


def blip_tokenizer_file(checkpoint_dir: str) -> Optional[str]:
    path = os.path.join(checkpoint_dir, "blip_tokenizer", "vocab.txt")
    return path if os.path.isfile(path) else None
