"""The evaluator's metric models and BLIP from their source weight files ->
state dicts in the port's names (the counterpart of the JAX package's
``convert/metric_models.py``).

Sources: CLIP ViT-L/14 (transformers ``CLIPModel``: ``vision_model.*``,
``text_model.*``, ``visual_projection``, ``text_projection``), DINO ViT-B/8
(the facebookresearch/dino timm-style dict, with its patch embedding's
bias), LPIPS-squeeze (torchvision ``features.*`` plus the lpips package's
``lin<i>.model.1`` heads) and BLIP-base (lavis: a timm ViT under
``visual_encoder.`` and the BERT decoder under ``text_decoder.``). Targets:
the port's ``ViT`` (one fused qkv projection), ``CLIPTextModel``,
``LPIPS`` and ``BlipTextDecoder``. Each function consumes its source dict
through a ``TrackingDict``, so the loader can refuse keys nobody read.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

StateDict = Dict[str, torch.Tensor]

# source keys the metric converters never read: non-parameter buffers and
# CLIP's contrastive temperature, which no metric uses
IGNORED_KEYS = (r".*position_ids", "logit_scale")


class TrackingDict(dict):
    """A state dict that records which keys were read."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.accessed = set()

    def __getitem__(self, key):
        self.accessed.add(key)
        return super().__getitem__(key)

    def unread(self) -> list:
        return sorted(set(self) - self.accessed)


def _same(out: StateDict, sd, src: str, dst: str, bias: bool = True) -> None:
    out[f"{dst}.weight"] = sd[f"{src}.weight"]
    if bias:
        out[f"{dst}.bias"] = sd[f"{src}.bias"]


def _prefix(sd, *candidates: str) -> str:
    for p in candidates:
        if any(k.startswith(p) for k in sd):
            return p
    return ""


def clip_vision_state_dict(sd: Mapping[str, torch.Tensor], layers: int) -> StateDict:
    """HF CLIPVisionModel(WithProjection) / CLIPModel -> the port's ViT
    ('clip' style): q/k/v fused into one projection."""
    pre = _prefix(sd, "vision_model.")
    out: StateDict = {
        "patch_embed.weight": sd[f"{pre}embeddings.patch_embedding.weight"],
        "cls_token": sd[f"{pre}embeddings.class_embedding"].reshape(1, 1, -1),
        "pos_embed": sd[f"{pre}embeddings.position_embedding.weight"][None],
        "projection.weight": sd["visual_projection.weight"],
    }
    _same(out, sd, f"{pre}pre_layrnorm", "pre_layernorm")  # HF's spelling
    _same(out, sd, f"{pre}post_layernorm", "post_layernorm")
    for i in range(layers):
        b = f"{pre}encoder.layers.{i}"
        for n in ("weight", "bias"):
            out[f"layers.{i}.qkv.{n}"] = torch.cat(
                [sd[f"{b}.self_attn.{p}_proj.{n}"] for p in "qkv"])
        _same(out, sd, f"{b}.self_attn.out_proj", f"layers.{i}.out_proj")
        _same(out, sd, f"{b}.layer_norm1", f"layers.{i}.ln1")
        _same(out, sd, f"{b}.layer_norm2", f"layers.{i}.ln2")
        _same(out, sd, f"{b}.mlp.fc1", f"layers.{i}.fc1")
        _same(out, sd, f"{b}.mlp.fc2", f"layers.{i}.fc2")
    return out


def clip_text_tower(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """A CLIPModel's text tower (``text_model.*``) in the port's names."""
    return {k: sd[k] for k in list(sd) if k.startswith("text_model.")
            and not k.endswith("position_ids")}


def timm_vit_state_dict(sd: Mapping[str, torch.Tensor], layers: int,
                        prefix: str = "") -> StateDict:
    """A timm-style ViT (DINO's, BLIP's vision tower) -> the port's ViT
    ('dino' style), with the patch embedding's bias."""
    p = prefix
    out: StateDict = {"cls_token": sd[f"{p}cls_token"], "pos_embed": sd[f"{p}pos_embed"]}
    _same(out, sd, f"{p}patch_embed.proj", "patch_embed")
    _same(out, sd, f"{p}norm", "norm")
    for i in range(layers):
        b = f"{p}blocks.{i}"
        for src, dst in (("norm1", "ln1"), ("attn.qkv", "qkv"), ("attn.proj", "out_proj"),
                         ("norm2", "ln2"), ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            _same(out, sd, f"{b}.{src}", f"layers.{i}.{dst}")
    return out


LPIPS_FIRES = (3, 4, 6, 7, 9, 10, 11, 12)  # squeezenet1_1's Fire modules in ``features``


def lpips_state_dict(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """torchvision squeezenet1_1 ``features.*`` (an optional ``net.`` in the
    names) plus the lpips heads ``lin<i>.model.1.weight`` (or
    ``lins.<i>.model.1.weight``) -> the port's LPIPS."""
    names = {k.replace("net.", ""): k for k in sd}
    view = {k: sd[v] for k, v in names.items()}  # reads (and so marks) every key once
    out: StateDict = {}
    _same(out, view, "features.0", "conv0")
    for j, fid in enumerate(LPIPS_FIRES):
        for src, dst in (("squeeze", "squeeze"), ("expand1x1", "expand1"),
                         ("expand3x3", "expand3")):
            _same(out, view, f"features.{fid}.{src}", f"fires.{j}.{dst}")
    for i in range(7):
        key = f"lin{i}.model.1.weight"
        out[f"lins.{i}.weight"] = view[key if key in view else f"lins.{i}.model.1.weight"]
    return out


def blip_decoder_state_dict(sd: Mapping[str, torch.Tensor], layers: int) -> StateDict:
    """HF BlipTextLMHeadModel (``text_decoder.*`` in lavis, ``bert.*`` on its
    own) -> the port's BlipTextDecoder. HF ties ``cls.predictions.bias`` to
    the decoder's bias and saves both; the standalone one is preferred and
    both are read."""
    pre = _prefix(sd, "text_decoder.bert.embeddings.", "bert.embeddings.", "embeddings.")
    pre = pre[: -len("embeddings.")] if pre else ""
    cls = pre.replace("bert.", "")
    out: StateDict = {"word_embedding": sd[f"{pre}embeddings.word_embeddings.weight"],
                      "position_embedding": sd[f"{pre}embeddings.position_embeddings.weight"]}
    _same(out, sd, f"{pre}embeddings.LayerNorm", "embed_norm")
    _same(out, sd, f"{cls}cls.predictions.transform.dense", "cls_dense")
    _same(out, sd, f"{cls}cls.predictions.transform.LayerNorm", "cls_norm")
    _same(out, sd, f"{cls}cls.predictions.decoder", "cls_decoder")
    if f"{cls}cls.predictions.bias" in sd:
        out["cls_decoder.bias"] = sd[f"{cls}cls.predictions.bias"]
    for i in range(layers):
        b = f"{pre}encoder.layer.{i}"
        for src, dst in (("attention.self.query", "self_q"), ("attention.self.key", "self_k"),
                         ("attention.self.value", "self_v"),
                         ("attention.output.dense", "self_out"),
                         ("attention.output.LayerNorm", "self_norm"),
                         ("crossattention.self.query", "cross_q"),
                         ("crossattention.self.key", "cross_k"),
                         ("crossattention.self.value", "cross_v"),
                         ("crossattention.output.dense", "cross_out"),
                         ("crossattention.output.LayerNorm", "cross_norm"),
                         ("intermediate.dense", "fc1"), ("output.dense", "fc2"),
                         ("output.LayerNorm", "out_norm")):
            _same(out, sd, f"{b}.{src}", f"layers.{i}.{dst}")
    return out


def check_consumed(sd: TrackingDict, what: str, ignore=IGNORED_KEYS) -> None:
    """Raises naming the keys of ``sd`` that no converter read (bar
    ``ignore``, regular expressions)."""
    unread = [k for k in sd.unread() if not any(re.fullmatch(p, k) for p in ignore)]
    if unread:
        raise KeyError(f"{what}: {len(unread)} unexpected keys no converter consumed, e.g. "
                       f"{unread[:8]}")
