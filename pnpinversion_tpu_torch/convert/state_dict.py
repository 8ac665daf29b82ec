"""Weight files on disk -> the port's modules, strictly (the counterpart of
the JAX package's ``convert/torch_to_jax.py``).

``read_state_dict(model_dir)`` reads a model directory: its ``*.safetensors``
files if it has any (``safetensors_io``), else its ``.bin``/``.ckpt``/``.pt``
files through ``torch.load(weights_only=True)``; shards are merged and a
``"state_dict"`` wrapper is unwrapped. ``load_strict`` fills a module built on
the meta device from a state dict in the module's own names: every parameter
and buffer must be filled, every key of the file consumed (bar a documented
ignore set), and an error names the missing and the unexpected keys; nothing
keeps a random weight. Weights are cast to the target dtype as they load.

The port's UNet, VAE and text tower carry the diffusers / transformers names
(``from_jax.py``), so an HF pipeline's files load by name, with two
renamings: the older diffusers VAE attention names (``query``/``key``/
``value``/``proj_attn``) and the text tower's optional ``text_model.``
prefix. A Linear-stored 1x1 projection (SD2.x's ``proj_in``/``proj_out``)
loads into the port's 1x1 convolution.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Iterable, Mapping, Optional

import torch

from pnpinversion_tpu_torch.convert.safetensors_io import read_safetensors

StateDict = Dict[str, torch.Tensor]

# keys real checkpoints carry that no module consumes (non-parameter
# buffers): the JAX package's ``convert/export.py::KNOWN_IGNORED_KEYS``
KNOWN_IGNORED_KEYS = frozenset({"text_model.embeddings.position_ids"})

_TORCH_SUFFIXES = (".bin", ".ckpt", ".pt")


def _torch_file(path: str) -> StateDict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def read_state_dict(model_dir: str) -> StateDict:
    """Every tensor of a model directory's weight files, merged: the
    ``*.safetensors`` files if there are any, else the ``.bin``/``.ckpt``/
    ``.pt`` ones. A key found in two shards raises."""
    if not os.path.isdir(model_dir):
        raise FileNotFoundError(f"no model directory {model_dir}")
    files = sorted(os.listdir(model_dir))
    chosen = ([f for f in files if f.endswith(".safetensors")]
              or [f for f in files if f.endswith(_TORCH_SUFFIXES)])
    if not chosen:
        raise FileNotFoundError(f"no weight files (*.safetensors, *.bin, *.ckpt, *.pt) "
                                f"in {model_dir}")
    out: StateDict = {}
    for f in chosen:
        path = os.path.join(model_dir, f)
        part = read_safetensors(path) if f.endswith(".safetensors") else _torch_file(path)
        dup = sorted(set(part) & set(out))
        if dup:
            raise ValueError(f"{path}: keys already read from another shard, e.g. {dup[:5]}")
        out.update(part)
    return out


def load_strict(module: torch.nn.Module, sd: Mapping[str, torch.Tensor], dtype: torch.dtype,
                device="cpu", ignore: Iterable[str] = (), what: str = "") -> torch.nn.Module:
    """Fills ``module`` (parameters and buffers, built on the meta device) from
    ``sd``, in the module's names, cast to ``dtype`` on ``device``. Raises
    naming the keys the module wants and ``sd`` lacks, the keys of ``sd`` the
    module has no use for (bar ``ignore``, exact names or regular
    expressions), and any shape that differs."""
    want = module.state_dict(keep_vars=True)
    ignore = list(ignore)
    missing = sorted(k for k in want if k not in sd)
    unexpected = sorted(k for k in sd if k not in want
                        and not any(k == p or re.fullmatch(p, k) for p in ignore))
    if missing or unexpected:
        raise KeyError(f"{what or type(module).__name__}: {len(missing)} missing keys "
                       f"{missing[:8]}, {len(unexpected)} unexpected keys {unexpected[:8]}")
    out: StateDict = {}
    for k, ref in want.items():
        v = sd[k]
        if tuple(v.shape) != tuple(ref.shape):
            if tuple(v.shape) + (1, 1) == tuple(ref.shape):  # a Linear-stored 1x1 conv
                v = v.reshape(ref.shape)
            else:
                raise ValueError(f"{what or type(module).__name__}: {k} has shape "
                                 f"{tuple(v.shape)}, the module wants {tuple(ref.shape)}")
        v = v.to(device=device)
        out[k] = v.to(dtype) if v.is_floating_point() and ref.is_floating_point() else v
    module.load_state_dict(out, strict=True, assign=True)
    return module


_OLD_VAE_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def vae_from_diffusers(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """An AutoencoderKL state dict in the port's names: the older diffusers
    attention names (``query``/``key``/``value``/``proj_attn``) renamed."""
    out: StateDict = {}
    for k, v in sd.items():
        m = re.fullmatch(r"(.*\.attentions\.0)\.(query|key|value|proj_attn)\.(weight|bias)", k)
        out[f"{m[1]}.{_OLD_VAE_ATTN[m[2]]}.{m[3]}" if m else k] = v
    return out


def clip_text_from_transformers(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """A CLIPTextModel state dict, with or without its ``text_model.``
    prefix, in the port's names (which carry the prefix)."""
    if any(k.startswith("text_model.") for k in sd):
        return dict(sd)
    return {f"text_model.{k}": v for k, v in sd.items()}


def load_pipeline_part(module: torch.nn.Module, part: str, sd: Mapping[str, torch.Tensor],
                       dtype: torch.dtype, device="cpu",
                       what: Optional[str] = None) -> torch.nn.Module:
    """One of a pipeline's modules (``part``: unet, vae or text) from a state
    dict in the diffusers / transformers layout."""
    if part == "vae":
        sd = vae_from_diffusers(sd)
    elif part == "text":
        sd = clip_text_from_transformers(sd)
    elif part != "unet":
        raise ValueError(f"unknown pipeline part {part!r}")
    return load_strict(module, sd, dtype, device, ignore=KNOWN_IGNORED_KEYS, what=what or part)
