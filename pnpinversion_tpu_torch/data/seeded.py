"""Seeded stand-ins for the data and the weights a user brings, for drives of
the port's entry points where neither is on the machine
(``scripts/rehearse_torch.py``, ``chip_smoke.py``).

``mini_pie_bench`` writes a PIE-Bench ``data/`` directory: seeded RGB images
under ``annotation_images/<category>_random/`` and a ``mapping_file.json``
whose items cycle through the given prompt pairs (by default four, with
their instructions and blend words) and carry ``mask_encode`` masks; the
callers (the rehearsal, the smoke, the tests) choose the keys, categories,
prompts and image files. ``write_hf_checkpoint`` writes a pipeline's
modules as an HF SD directory of f16 safetensors (the VAE under the older
diffusers attention names, which the loader renames), with the port's own
writer; ``bpe_vocab`` writes a tiny CLIP BPE vocabulary that spells the given
prompts, for its ``tokenizer/``.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from pnpinversion_tpu_torch.data.pie_bench import mask_encode

# (source, target, instruction, blend words): PIE-Bench's bracketed words
PROMPTS = (
    ("a [cat] sitting on a wooden table", "a [dog] sitting on a wooden table",
     "change the cat to a dog", "cat dog"),
    ("a round [cake] with orange frosting", "a square [cake] with orange frosting",
     "make the cake square", "cake cake"),
    ("a [car] parked on the street", "a [bicycle] parked on the street",
     "replace the car with a bicycle", "car bicycle"),
    ("a vase of [roses] on a desk", "a vase of [tulips] on a desk",
     "swap the roses for tulips", "roses tulips"),
)


def mini_pie_bench(root: str, n: int, size: int = 512, seed: int = 0,
                   prompts: Sequence[Tuple[str, str, str, str]] = PROMPTS,
                   key: str = "{:06d}", category: Callable[[int], int] = lambda i: 0,
                   ext: str = "jpg") -> str:
    """``root``/data with n seeded RGB images (size x size, uniform noise from
    ``RandomState(seed)``). Item i is keyed ``key.format(i)``, its image is
    ``<category(i)>_random/<its key>.<ext>`` (its editing type category(i)),
    its prompts ``prompts[i % len(prompts)]`` (source, target, instruction,
    blend words) and its mask a 512^2 rectangle that grows with i. Returns
    the data directory."""
    rng = np.random.RandomState(seed)
    data = os.path.join(root, "data")
    mapping = {}
    for i in range(n):
        name, cat = key.format(i), category(i)
        rel = f"{cat}_random/{name}.{ext}"
        path = os.path.join(data, "annotation_images", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray((rng.rand(size, size, 3) * 255).astype(np.uint8)).save(path)
        mask = np.zeros((512, 512), np.uint8)
        mask[128 + 8 * (i % 16): 384, 96: 320 + 8 * (i % 16)] = 1
        src, tar, instruction, blend = prompts[i % len(prompts)]
        mapping[name] = {"image_path": rel, "original_prompt": src, "editing_prompt": tar,
                         "editing_instruction": instruction, "editing_type_id": str(cat),
                         "blended_word": blend, "mask": mask_encode(mask)}
    with open(os.path.join(data, "mapping_file.json"), "w") as f:
        json.dump(mapping, f)
    return data


def bpe_vocab(root: str, prompts: Sequence[str]) -> str:
    """A tiny CLIP BPE vocabulary in the HF layout (``vocab.json`` +
    ``merges.txt``): every byte and its word-final form, merges that build
    the prompts' words left to right, the two specials. Returns its dir."""
    from pnpinversion_tpu_torch.utils.tokenizer import _bytes_to_unicode

    alphabet = list(_bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(alphabet + [c + "</w>" for c in alphabet])}
    merges = []
    for word in sorted({w for p in prompts for w in p.lower().split()}):
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            merge = f"{parts[0]} {parts[1]}"
            if merge not in merges:
                merges.append(merge)
            parts = [parts[0] + parts[1]] + parts[2:]
            vocab.setdefault(parts[0], len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(root, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return root


_OLD_VAE_ATTN = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


def write_hf_checkpoint(root: str, modules: Dict[str, torch.nn.Module]) -> int:
    """The modules ({"unet", "vae", "text"}) as an HF SD directory of f16
    safetensors (the VAE under the older diffusers attention names), written
    with the port's own writer. Returns the bytes written."""
    from pnpinversion_tpu_torch.convert.safetensors_io import write_safetensors

    total = 0
    for part, sub in (("unet", "unet"), ("vae", "vae"), ("text", "text_encoder")):
        sd = {}
        for k, v in modules[part].state_dict().items():
            for new, old in _OLD_VAE_ATTN.items():
                if part == "vae" and f".attentions.0.{new}." in k:
                    k = k.replace(f".attentions.0.{new}.", f".attentions.0.{old}.")
            sd[k] = v.detach().to("cpu", torch.float16)
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        path = os.path.join(root, sub, "diffusion_pytorch_model.safetensors")
        write_safetensors(path, sd)
        total += os.path.getsize(path)
    return total
