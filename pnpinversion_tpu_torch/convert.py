"""Weight carry-over from the JAX package's parameter trees.

``from_jax_params`` takes a JAX param tree whose leaves are numpy arrays (the
layout of ``pnpinversion_tpu``'s ``init_*_params``) and returns the port's
module with those weights. The tree is first renamed into the diffusers /
transformers state-dict layout (Linear kernel (in, out) -> weight (out, in);
conv HWIO -> OIHW; norm scale -> weight), an own copy of the JAX package's
``convert/export.py`` mapping, then loaded with ``strict=True`` so that every
key on both sides is accounted for.
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
from pnpinversion_tpu_torch.models.clip_text import CLIPTextModel
from pnpinversion_tpu_torch.models.unet import UNet
from pnpinversion_tpu_torch.models.vae import VAE

StateDict = Dict[str, np.ndarray]


def _lin(sd: StateDict, name: str, p) -> None:
    sd[f"{name}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        sd[f"{name}.bias"] = np.asarray(p["bias"])


def _conv(sd: StateDict, name: str, p) -> None:
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


def _load(module: torch.nn.Module, sd: StateDict) -> torch.nn.Module:
    module.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in sd.items()},
        strict=True, assign=True)
    return module


def from_jax_params(params: Dict[str, Any], config):
    """JAX param tree (numpy leaves) -> the port's module(s) on the CPU, in f32.

    config: a UNetConfig, VAEConfig or CLIPTextConfig gives that one module; a
    StableDiffusionConfig (params {'unet', 'vae', 'text'}) gives a dict of all
    three."""
    if isinstance(config, StableDiffusionConfig):
        return {"unet": from_jax_params(params["unet"], config.unet),
                "vae": from_jax_params(params["vae"], config.vae),
                "text": from_jax_params(params["text"], config.text)}
    with torch.device("meta"):
        if isinstance(config, UNetConfig):
            module, sd = UNet(config), unet_state_dict(params)
        elif isinstance(config, VAEConfig):
            module, sd = VAE(config), vae_state_dict(params)
        elif isinstance(config, CLIPTextConfig):
            module, sd = CLIPTextModel(config), clip_text_state_dict(params)
        else:
            raise TypeError(f"no module for config {type(config).__name__}")
    return _load(module, sd)
