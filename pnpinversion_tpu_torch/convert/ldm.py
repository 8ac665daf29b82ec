"""CompVis LDM checkpoints (one ``.ckpt`` holding the UNet, the VAE and the
text tower: InstructPix2Pix's, InstructDiffusion's) -> state dicts in the
port's names (the counterpart of the JAX package's
``convert/ldm_to_jax.py``).

The three models sit under ``model.diffusion_model.``,
``first_stage_model.`` and ``cond_stage_model.transformer.``. Their keys are
renamed into the diffusers layout the port's modules carry (the renaming
diffusers' own conversion scripts do), the VAE's mid-attention 1x1 convs
squeezed to Linear weights. The training-time state a real checkpoint
carries (EMA shadows, the diffusion buffers, loss weights) is ignored; any
other key outside the three prefixes is refused, as is any key of the three
that no module consumes. ``ldm_state_dict`` is the inverse, for writing
test checkpoints.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from pnpinversion_tpu_torch.configs import StableDiffusionConfig, UNetConfig, VAEConfig

StateDict = Dict[str, torch.Tensor]

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."
TEXT_PREFIX = "cond_stage_model.transformer."
MODEL_PREFIXES = (UNET_PREFIX, VAE_PREFIX, TEXT_PREFIX)
# the JAX convert CLI's ``_LDM_IGNORED_PREFIXES``: EMA shadows, the diffusion
# buffer bank (betas, alphas, posterior_*), loss weights
IGNORED_PREFIXES = ("model_ema.", "betas", "alphas_cumprod", "sqrt_", "log_one_minus",
                    "posterior_", "lvlb_weights", "logvar", "scale_factor")

_UNET_RESNET = {"in_layers.0": "norm1", "in_layers.2": "conv1", "out_layers.0": "norm2",
                "out_layers.3": "conv2", "emb_layers.1": "time_emb_proj",
                "skip_connection": "conv_shortcut"}
_VAE_RESNET = {"norm1": "norm1", "conv1": "conv1", "norm2": "norm2", "conv2": "conv2",
               "nin_shortcut": "conv_shortcut"}
_VAE_ATTN = {"norm": "group_norm", "q": "to_q", "k": "to_k", "v": "to_v",
             "proj_out": "to_out.0"}


def unet_prefixes(config: UNetConfig) -> Dict[str, Tuple[str, bool]]:
    """CompVis UNet prefix -> (diffusers prefix, is a resnet), walked from the
    config as the JAX ``convert_ldm_unet`` walks it."""
    n, L = len(config.block_out_channels), config.layers_per_block
    ren = {"time_embed.0": ("time_embedding.linear_1", False),
           "time_embed.2": ("time_embedding.linear_2", False),
           "input_blocks.0.0": ("conv_in", False), "out.0": ("conv_norm_out", False),
           "out.2": ("conv_out", False), "middle_block.0": ("mid_block.resnets.0", True),
           "middle_block.1": ("mid_block.attentions.0", False),
           "middle_block.2": ("mid_block.resnets.1", True)}
    idx = 1
    for i in range(n):
        for j in range(L):
            ren[f"input_blocks.{idx}.0"] = (f"down_blocks.{i}.resnets.{j}", True)
            if config.cross_attention[i]:
                ren[f"input_blocks.{idx}.1"] = (f"down_blocks.{i}.attentions.{j}", False)
            idx += 1
        if i < n - 1:
            ren[f"input_blocks.{idx}.0.op"] = (f"down_blocks.{i}.downsamplers.0.conv", False)
            idx += 1
    idx = 0
    for i in range(n):
        attn = config.cross_attention[n - 1 - i]
        for j in range(L + 1):
            ren[f"output_blocks.{idx}.0"] = (f"up_blocks.{i}.resnets.{j}", True)
            if attn:
                ren[f"output_blocks.{idx}.1"] = (f"up_blocks.{i}.attentions.{j}", False)
            if j == L and i < n - 1:
                ren[f"output_blocks.{idx}.{2 if attn else 1}.conv"] = (
                    f"up_blocks.{i}.upsamplers.0.conv", False)
            idx += 1
    return ren


def vae_prefixes(config: VAEConfig) -> Dict[str, Tuple[str, bool]]:
    """CompVis VAE prefix -> (diffusers prefix, is a resnet); the decoder's
    levels run in reverse in CompVis."""
    n = len(config.block_out_channels)
    ren = {}
    for side in ("encoder", "decoder"):
        ren[f"{side}.conv_in"] = (f"{side}.conv_in", False)
        ren[f"{side}.norm_out"] = (f"{side}.conv_norm_out", False)
        ren[f"{side}.conv_out"] = (f"{side}.conv_out", False)
        ren[f"{side}.mid.block_1"] = (f"{side}.mid_block.resnets.0", True)
        ren[f"{side}.mid.block_2"] = (f"{side}.mid_block.resnets.1", True)
        for old, new in _VAE_ATTN.items():
            ren[f"{side}.mid.attn_1.{old}"] = (f"{side}.mid_block.attentions.0.{new}", False)
    for i in range(n):
        for j in range(config.layers_per_block):
            ren[f"encoder.down.{i}.block.{j}"] = (f"encoder.down_blocks.{i}.resnets.{j}", True)
        ren[f"encoder.down.{i}.downsample.conv"] = (
            f"encoder.down_blocks.{i}.downsamplers.0.conv", False)
        for j in range(config.layers_per_block + 1):
            ren[f"decoder.up.{n - 1 - i}.block.{j}"] = (f"decoder.up_blocks.{i}.resnets.{j}", True)
        ren[f"decoder.up.{n - 1 - i}.upsample.conv"] = (
            f"decoder.up_blocks.{i}.upsamplers.0.conv", False)
    for name in ("quant_conv", "post_quant_conv"):
        ren[name] = (name, False)
    return ren


def _rename(sd: Mapping[str, torch.Tensor], prefixes: Dict[str, Tuple[str, bool]],
            resnet_parts: Dict[str, str]) -> StateDict:
    """Each key's longest matching prefix renamed (and its resnet part); a
    key no prefix matches keeps its name, so a strict load names it."""
    out: StateDict = {}
    for key, v in sd.items():
        parts = key.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            head = ".".join(parts[:cut])
            if head in prefixes:
                new, resnet = prefixes[head]
                rest = ".".join(parts[cut:])
                if resnet:
                    for old, part in resnet_parts.items():
                        if rest.startswith(old + "."):
                            rest = part + rest[len(old):]
                            break
                key = f"{new}.{rest}"
                break
        out[key] = v
    return out


def split_ldm(sd: Mapping[str, torch.Tensor]) -> Dict[str, StateDict]:
    """{unet, vae, text} state dicts of a CompVis checkpoint, prefixes
    stripped; refuses a key outside the three model prefixes that is not
    training-time state."""
    stray = sorted(k for k in sd if not k.startswith(MODEL_PREFIXES + IGNORED_PREFIXES))
    if stray:
        raise ValueError(f"{len(stray)} unrecognized LDM keys, e.g. {stray[:5]}")
    return {part: {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
            for part, p in (("unet", UNET_PREFIX), ("vae", VAE_PREFIX), ("text", TEXT_PREFIX))}


def ldm_to_diffusers(sd: Mapping[str, torch.Tensor],
                     config: StableDiffusionConfig) -> Dict[str, StateDict]:
    """A CompVis checkpoint's state dict -> {unet, vae, text} in the
    diffusers / transformers layout the port's modules load."""
    parts = split_ldm(sd)
    vae = _rename(parts["vae"], vae_prefixes(config.vae), _VAE_RESNET)
    for k, v in vae.items():  # CompVis stores the mid-attention projections as 1x1 convs
        if ".mid_block.attentions.0.to_" in k and v.dim() == 4:
            vae[k] = v[:, :, 0, 0]
    return {"unet": _rename(parts["unet"], unet_prefixes(config.unet), _UNET_RESNET),
            "vae": vae, "text": parts["text"]}


def _inverse(prefixes: Dict[str, Tuple[str, bool]], resnet_parts: Dict[str, str]):
    return ({new: (old, resnet) for old, (new, resnet) in prefixes.items()},
            {new: old for old, new in resnet_parts.items()})


def ldm_state_dict(unet: Mapping[str, torch.Tensor], vae: Mapping[str, torch.Tensor],
                   text: Mapping[str, torch.Tensor], config: StableDiffusionConfig) -> StateDict:
    """The inverse of ``ldm_to_diffusers``: the port's (diffusers-named) state
    dicts -> one CompVis state dict, the VAE's mid-attention projections as
    1x1 convs."""
    out: StateDict = {}
    u = _rename(unet, *_inverse(unet_prefixes(config.unet), _UNET_RESNET))
    out.update({UNET_PREFIX + k: v for k, v in u.items()})
    v_sd = _rename(vae, *_inverse(vae_prefixes(config.vae), _VAE_RESNET))
    for k, v in v_sd.items():
        if ".mid.attn_1." in k and k.endswith(".weight") and v.dim() == 2:
            v = v[:, :, None, None]
        out[VAE_PREFIX + k] = v
    out.update({TEXT_PREFIX + k: v for k, v in text.items()})
    return out
