"""Weight carry-over from the JAX package's parameter trees.

``from_jax_params`` takes a JAX param tree whose leaves are numpy arrays (the
layout of ``pnpinversion_tpu``'s ``init_*_params``) and returns the port's
module with those weights. The tree is first renamed into the diffusers /
transformers state-dict layout (Linear kernel (in, out) -> weight (out, in);
conv HWIO -> OIHW; norm scale -> weight), an own copy of the JAX package's
``convert/export.py`` mapping, then loaded with ``strict=True`` so that every
key on both sides is accounted for. A UNet tree in the JAX w8 layout
(``kernel_w8``, ``kernel_scale``: ``ops/quant.py``) loads into a UNet whose
layers ``quantize_unet_dots`` swapped the same way.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from pnpinversion_tpu_torch.configs import (
    CLIPTextConfig,
    StableDiffusionConfig,
    UNetConfig,
    VAEConfig,
)
from pnpinversion_tpu_torch.models.blip import BlipTextConfig, BlipTextDecoder
from pnpinversion_tpu_torch.models.clip_text import CLIPTextModel
from pnpinversion_tpu_torch.models.lpips import LPIPS
from pnpinversion_tpu_torch.models.unet import UNet
from pnpinversion_tpu_torch.models.vae import VAE
from pnpinversion_tpu_torch.models.vit import ViT, ViTConfig
from pnpinversion_tpu_torch.ops.quant import quantize_unet_dots

StateDict = Dict[str, np.ndarray]


def _lin(sd: StateDict, name: str, p) -> None:
    if "kernel_w8" in p:  # the w8 layout (ops/quant.py): int8 (in, out) and its scale
        sd[f"{name}.weight"] = np.asarray(p["kernel_w8"]).T
        sd[f"{name}.weight_scale"] = np.asarray(p["kernel_scale"])
    else:
        sd[f"{name}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        sd[f"{name}.bias"] = np.asarray(p["bias"])


def _conv(sd: StateDict, name: str, p) -> None:
    if "kernel_w8" in p and np.ndim(p["kernel_w8"]) == 2:  # a w8 1x1 conv: the linear layout
        _lin(sd, name, p)
        return
    if "kernel_w8" in p:
        sd[f"{name}.weight"] = np.asarray(p["kernel_w8"]).transpose(3, 2, 0, 1)
        sd[f"{name}.weight_scale"] = np.asarray(p["kernel_scale"])
    else:
        sd[f"{name}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        sd[f"{name}.bias"] = np.asarray(p["bias"])


def _norm(sd: StateDict, name: str, p) -> None:
    sd[f"{name}.weight"] = np.asarray(p["scale"])
    sd[f"{name}.bias"] = np.asarray(p["bias"])


def _resnet(sd: StateDict, name: str, p) -> None:
    _norm(sd, f"{name}.norm1", p["norm1"])
    _conv(sd, f"{name}.conv1", p["conv1"])
    _norm(sd, f"{name}.norm2", p["norm2"])
    _conv(sd, f"{name}.conv2", p["conv2"])
    if "time_emb_proj" in p:
        _lin(sd, f"{name}.time_emb_proj", p["time_emb_proj"])
    if "conv_shortcut" in p:
        _conv(sd, f"{name}.conv_shortcut", p["conv_shortcut"])


def _attn(sd: StateDict, name: str, p) -> None:
    for k in ("to_q", "to_k", "to_v"):
        _lin(sd, f"{name}.{k}", p[k])
    _lin(sd, f"{name}.to_out.0", p["to_out"])


def _transformer(sd: StateDict, name: str, p) -> None:
    _norm(sd, f"{name}.norm", p["norm"])
    _conv(sd, f"{name}.proj_in", p["proj_in"])
    _conv(sd, f"{name}.proj_out", p["proj_out"])
    for i, blk in enumerate(p["blocks"]):
        tb = f"{name}.transformer_blocks.{i}"
        for k in ("norm1", "norm2", "norm3"):
            _norm(sd, f"{tb}.{k}", blk[k])
        _attn(sd, f"{tb}.attn1", blk["attn1"])
        _attn(sd, f"{tb}.attn2", blk["attn2"])
        _lin(sd, f"{tb}.ff.net.0.proj", blk["ff"]["geglu"])
        _lin(sd, f"{tb}.ff.net.2", blk["ff"]["out"])


def unet_state_dict(params) -> StateDict:
    sd: StateDict = {}
    _lin(sd, "time_embedding.linear_1", params["time_embedding"]["linear_1"])
    _lin(sd, "time_embedding.linear_2", params["time_embedding"]["linear_2"])
    _conv(sd, "conv_in", params["conv_in"])
    _norm(sd, "conv_norm_out", params["conv_norm_out"])
    _conv(sd, "conv_out", params["conv_out"])
    for part, blocks in (("down", params["down_blocks"]), ("up", params["up_blocks"])):
        for i, blk in enumerate(blocks):
            for j, rn in enumerate(blk["resnets"]):
                _resnet(sd, f"{part}_blocks.{i}.resnets.{j}", rn)
            for j, at in enumerate(blk["attentions"]):
                _transformer(sd, f"{part}_blocks.{i}.attentions.{j}", at)
            if "downsample" in blk:
                _conv(sd, f"down_blocks.{i}.downsamplers.0.conv", blk["downsample"])
            if "upsample" in blk:
                _conv(sd, f"up_blocks.{i}.upsamplers.0.conv", blk["upsample"])
    for j, rn in enumerate(params["mid_block"]["resnets"]):
        _resnet(sd, f"mid_block.resnets.{j}", rn)
    _transformer(sd, "mid_block.attentions.0", params["mid_block"]["attentions"][0])
    return sd


def _vae_mid(sd: StateDict, name: str, p) -> None:
    _resnet(sd, f"{name}.resnets.0", p["resnet_1"])
    _resnet(sd, f"{name}.resnets.1", p["resnet_2"])
    a = p["attn"]
    _norm(sd, f"{name}.attentions.0.group_norm", a["group_norm"])
    _attn(sd, f"{name}.attentions.0", a)


def vae_state_dict(params) -> StateDict:
    sd: StateDict = {}
    enc, dec = params["encoder"], params["decoder"]
    _conv(sd, "encoder.conv_in", enc["conv_in"])
    for i, blk in enumerate(enc["down_blocks"]):
        for j, rn in enumerate(blk["resnets"]):
            _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", rn)
        if "downsample" in blk:
            _conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv", blk["downsample"])
    _vae_mid(sd, "encoder.mid_block", enc["mid"])
    _norm(sd, "encoder.conv_norm_out", enc["norm_out"])
    _conv(sd, "encoder.conv_out", enc["conv_out"])
    _conv(sd, "decoder.conv_in", dec["conv_in"])
    _vae_mid(sd, "decoder.mid_block", dec["mid"])
    for i, blk in enumerate(dec["up_blocks"]):
        for j, rn in enumerate(blk["resnets"]):
            _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", rn)
        if "upsample" in blk:
            _conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv", blk["upsample"])
    _norm(sd, "decoder.conv_norm_out", dec["norm_out"])
    _conv(sd, "decoder.conv_out", dec["conv_out"])
    _conv(sd, "quant_conv", params["quant_conv"])
    _conv(sd, "post_quant_conv", params["post_quant_conv"])
    return sd


def clip_text_state_dict(params) -> StateDict:
    sd: StateDict = {
        "text_model.embeddings.token_embedding.weight": np.asarray(params["token_embedding"]),
        "text_model.embeddings.position_embedding.weight":
            np.asarray(params["position_embedding"]),
    }
    _norm(sd, "text_model.final_layer_norm", params["final_layer_norm"])
    for i, lp in enumerate(params["layers"]):
        base = f"text_model.encoder.layers.{i}"
        _norm(sd, f"{base}.layer_norm1", lp["layer_norm1"])
        for k in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(sd, f"{base}.self_attn.{k}", lp[k])
        _norm(sd, f"{base}.layer_norm2", lp["layer_norm2"])
        _lin(sd, f"{base}.mlp.fc1", lp["fc1"])
        _lin(sd, f"{base}.mlp.fc2", lp["fc2"])
    return sd


def vit_state_dict(params, config: ViTConfig) -> StateDict:
    """The JAX ViT tree in the port's names (the tree's own, fused qkv). A
    DINO tree without ``patch_bias`` (the JAX init has none) gets a zero one."""
    sd: StateDict = {"cls_token": np.asarray(params["cls_token"]),
                     "pos_embed": np.asarray(params["pos_embed"])}
    patch = {"kernel": params["patch_embed"]}
    if config.style == "dino":
        patch["bias"] = params.get("patch_bias", np.zeros((config.width,), np.float32))
    _conv(sd, "patch_embed", patch)
    if config.style == "clip":
        _norm(sd, "pre_layernorm", params["pre_layernorm"])
        _norm(sd, "post_layernorm", params["post_layernorm"])
        _lin(sd, "projection", params["projection"])
    else:
        _norm(sd, "norm", params["norm"])
    for i, lp in enumerate(params["layers"]):
        for k in ("ln1", "ln2"):
            _norm(sd, f"layers.{i}.{k}", lp[k])
        for k in ("qkv", "out_proj", "fc1", "fc2"):
            _lin(sd, f"layers.{i}.{k}", lp[k])
    return sd


def blip_decoder_state_dict(params) -> StateDict:
    """The JAX BLIP decoder tree in the port's names (the tree's own)."""
    sd: StateDict = {"word_embedding": np.asarray(params["word_embedding"]),
                     "position_embedding": np.asarray(params["position_embedding"])}
    _norm(sd, "embed_norm", params["embed_norm"])
    for i, lp in enumerate(params["layers"]):
        for k, p in lp.items():
            (_norm if k.endswith("norm") else _lin)(sd, f"layers.{i}.{k}", p)
    _lin(sd, "cls_dense", params["cls_dense"])
    _norm(sd, "cls_norm", params["cls_norm"])
    _lin(sd, "cls_decoder", params["cls_decoder"])
    return sd


def stylediffusion_mapper_from_jax(params, device=None) -> Dict[str, torch.Tensor]:
    """A JAX StyleDiffusion mapper tree (stacked over the steps (T, ...), or
    one step's) -> the port's flat dict of f32 tensors for one image, with
    the leading image axis: (1, T, ...) or (1, ...)."""
    flat = {}
    for name in ("conv_start", "conv_end"):
        for k in ("kernel", "bias"):
            flat[f"{name}.{k}"] = params[name][k]
    for b, blk in enumerate(params["blocks"]):
        for k in ("kernel", "bias"):
            flat[f"blocks.{b}.conv.{k}"] = blk["conv"][k]
        flat[f"blocks.{b}.bn_scale"], flat[f"blocks.{b}.bn_bias"] = blk["bn_scale"], blk["bn_bias"]
    return {k: torch.as_tensor(np.array(v, dtype=np.float32), device=device)[None]
            for k, v in flat.items()}


def lpips_state_dict(params) -> StateDict:
    sd: StateDict = {}
    _conv(sd, "conv0", params["conv0"])
    for i, fire in enumerate(params["fires"]):
        for k in ("squeeze", "expand1", "expand3"):
            _conv(sd, f"fires.{i}.{k}", fire[k])
    for i, lin in enumerate(params["lins"]):
        _conv(sd, f"lins.{i}", lin)
    return sd


def clip_modules_from_jax_params(params: Dict[str, Any], clip_vision: ViTConfig,
                                 clip_text: CLIPTextConfig) -> dict:
    """The CLIP towers of a JAX tree (``clip_vision``, ``clip_text``,
    ``clip_text_proj``; numpy leaves: the ``MetricsCalculator``'s or the
    ``PairClipFilter``'s) -> the port's modules of the same names, on the CPU
    in f32."""
    proj = params["clip_text_proj"]["kernel"]
    with torch.device("meta"):
        text_proj = torch.nn.Linear(*np.shape(proj), bias=False)
    return {"clip_vision": from_jax_params(params["clip_vision"], clip_vision),
            "clip_text": from_jax_params(params["clip_text"], clip_text),
            "clip_text_proj": _load(text_proj, {"weight": np.asarray(proj).T})}


def metric_modules_from_jax_params(params: Dict[str, Any], clip_vision: ViTConfig,
                                   clip_text: CLIPTextConfig, dino: ViTConfig) -> dict:
    """The JAX ``MetricsCalculator``'s tree (``clip_vision``, ``clip_text``,
    ``clip_text_proj``, ``lpips``, ``dino``; numpy leaves) -> the port's
    modules of the same names, on the CPU in f32."""
    with torch.device("meta"):
        lpips = LPIPS()
    return {**clip_modules_from_jax_params(params, clip_vision, clip_text),
            "lpips": _load(lpips, lpips_state_dict(params["lpips"])),
            "dino": from_jax_params(params["dino"], dino)}


def _optax_states(tree) -> list:
    """Every optax state in a numpy copy of an optax state tree: the
    namedtuples (``ScaleByAdamState``, ``ScaleByScheduleState``, ...), found
    by their fields, as the port has no optax."""
    if hasattr(tree, "_fields"):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [s for t in tree for s in _optax_states(t)]
    return []


def train_state_from_jax(state, config: UNetConfig) -> Dict[str, Any]:
    """The JAX ``EditTrainer``'s state with numpy leaves
    (``jax.device_get(trainer.state)``: params, ema, optax's
    ``chain(clip_by_global_norm, adamw)`` state, step) -> the port's
    ``EditTrainer.load_state_dict`` layout: params, ema, the Adam moments
    mu/nu by parameter name in the port's layouts, Adam's count and step.
    The schedule's count, which optax keeps apart, must equal Adam's: the
    port keeps one."""
    kernel = np.shape(state["params"]["conv_in"]["kernel"])
    if kernel[2] != config.in_channels:
        raise ValueError(f"the state's UNet takes {kernel[2]} input channels, the config "
                         f"{config.in_channels}")
    opt = _optax_states(state["opt"])
    adam = [s for s in opt if {"count", "mu", "nu"} <= set(s._fields)]
    counts = {int(np.asarray(s.count)) for s in opt if "count" in s._fields}
    if len(adam) != 1 or len(counts) != 1:
        raise ValueError(f"want one Adam state and one count in the optax state, got "
                         f"{len(adam)} and counts {sorted(counts)}")
    return {"params": unet_state_dict(state["params"]), "ema": unet_state_dict(state["ema"]),
            "mu": unet_state_dict(adam[0].mu), "nu": unet_state_dict(adam[0].nu),
            "count": counts.pop(), "step": int(np.asarray(state["step"]))}


def _tensor(v) -> torch.Tensor:
    """f32, or int8 for a w8 weight."""
    v = np.asarray(v)
    return torch.from_numpy(np.ascontiguousarray(v, dtype=np.int8 if v.dtype == np.int8
                                                 else np.float32))


def _load(module: torch.nn.Module, sd: StateDict) -> torch.nn.Module:
    module.load_state_dict({k: _tensor(v) for k, v in sd.items()}, strict=True, assign=True)
    return module


def from_jax_params(params: Dict[str, Any], config):
    """JAX param tree (numpy leaves) -> the port's module(s) on the CPU, in f32.

    config: a UNetConfig, VAEConfig, CLIPTextConfig, ViTConfig or
    BlipTextConfig (the BLIP decoder) gives that one module; a StableDiffusionConfig (params {'unet', 'vae', 'text'}) gives
    a dict of all three."""
    if isinstance(config, StableDiffusionConfig):
        return {"unet": from_jax_params(params["unet"], config.unet),
                "vae": from_jax_params(params["vae"], config.vae),
                "text": from_jax_params(params["text"], config.text)}
    with torch.device("meta"):
        if isinstance(config, UNetConfig):
            module, sd = UNet(config), unet_state_dict(params)
            if any(np.asarray(v).dtype == np.int8 for v in sd.values()):  # a w8 tree
                quantize_unet_dots(module, convs="kernel_w8" in params["conv_in"])
        elif isinstance(config, VAEConfig):
            module, sd = VAE(config), vae_state_dict(params)
        elif isinstance(config, CLIPTextConfig):
            module, sd = CLIPTextModel(config), clip_text_state_dict(params)
        elif isinstance(config, ViTConfig):
            module, sd = ViT(config), vit_state_dict(params, config)
        elif isinstance(config, BlipTextConfig):
            module, sd = BlipTextDecoder(config), blip_decoder_state_dict(params)
        else:
            raise TypeError(f"no module for config {type(config).__name__}")
    return _load(module, sd)
