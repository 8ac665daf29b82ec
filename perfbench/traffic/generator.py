"""The one traffic generator: a seeded PIE-Bench directory from a mix's
parameters (a frozen copy of the port's ``data/seeded.py::mini_pie_bench``,
with photo-like images in place of its per-pixel noise).

Each item draws a prompt pair from the pool, an image and a mask from the
seed: the image is uniform noise at ``noise_cells``² pixels upsampled bicubic
to ``size``² and saved as a JPEG at ``quality`` (smooth like a photo, so its
JPEG decode and the strips' encode cost what a photo's do); the mask is a
rectangle or an ellipse whose area is a seeded share in [``min_share``,
``max_share``] of the image, run-length encoded as PIE-Bench stores it. Every
seed gives the same sizes: only the pixels, prompts and masks move. The
prompts' words are spelled by a CLIP BPE vocabulary written beside the data
(``tokenizer/``: every byte, merges that build each word left to right).
"""
from __future__ import annotations

import json
import os
from typing import List, Sequence

import numpy as np
from PIL import Image

from perfbench.reference.text import bytes_to_unicode

HERE = os.path.dirname(os.path.abspath(__file__))


def prompt_pool(name: str = "prompts") -> List[list]:
    with open(os.path.join(HERE, f"{name}.json")) as f:
        return json.load(f)["pairs"]


def rle_encode(mask: np.ndarray) -> List[int]:
    flat = np.concatenate([[0], np.asarray(mask).reshape(-1).astype(np.int8), [0]])
    diff = np.diff(flat)
    starts, ends = np.where(diff == 1)[0], np.where(diff == -1)[0]
    return [int(v) for s, e in zip(starts, ends) for v in (s, e - s)]


def _mask(rng: np.random.Generator, lo: float, hi: float, size: int = 512) -> np.ndarray:
    share = rng.uniform(lo, hi)
    aspect = rng.uniform(0.6, 1.6)
    yy, xx = np.mgrid[0:size, 0:size]
    if rng.random() < 0.5:
        h = min(size - 2, int(round(np.sqrt(share * size * size / aspect))))
        w = min(size - 2, int(round(share * size * size / h)))
        y0, x0 = rng.integers(1, size - h), rng.integers(1, size - w)
        return ((yy >= y0) & (yy < y0 + h) & (xx >= x0) & (xx < x0 + w)).astype(np.uint8)
    a = min(size / 2 - 1, np.sqrt(share * size * size / np.pi * aspect))
    b = min(size / 2 - 1, share * size * size / (np.pi * a))
    cy, cx = rng.uniform(b, size - b), rng.uniform(a, size - a)
    return ((((xx - cx) / a) ** 2 + ((yy - cy) / b) ** 2) <= 1.0).astype(np.uint8)


def write_vocab(root: str, prompts: Sequence[str]) -> str:
    """A CLIP BPE vocabulary (``vocab.json`` + ``merges.txt``) that spells
    every word of ``prompts``; returns its directory."""
    alphabet = list(bytes_to_unicode().values())
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


def generate(root: str, n: int, seed: int, salt: int, mix: dict) -> str:
    """``root``/data holding n items drawn from (seed, salt); returns it."""
    rng = np.random.default_rng([seed, salt])
    img = mix["images"]
    pool = prompt_pool(mix.get("prompt_pool", "prompts"))
    data = os.path.join(root, "data")
    mapping = {}
    for i in range(n):
        src, tgt, instruction, blend = pool[int(rng.integers(len(pool)))]
        cat = int(rng.integers(10))
        key = f"{salt}{i:05d}"
        rel = f"{cat}_seeded/{key}.{img['format']}"
        path = os.path.join(data, "annotation_images", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cells = (rng.random((img["noise_cells"], img["noise_cells"], 3)) * 255).astype(np.uint8)
        picture = Image.fromarray(cells).resize((img["size"], img["size"]), Image.BICUBIC)
        picture.save(path, quality=img["quality"]) if img["format"] == "jpg" else picture.save(path)
        mapping[key] = {"image_path": rel, "original_prompt": src, "editing_prompt": tgt,
                        "editing_instruction": instruction, "editing_type_id": str(cat),
                        "blended_word": blend,
                        "mask": rle_encode(_mask(rng, *mix["mask_share"]))}
    with open(os.path.join(data, "mapping_file.json"), "w") as f:
        json.dump(mapping, f)
    return data


def vocabulary(root: str, mix: dict) -> str:
    pool = prompt_pool(mix.get("prompt_pool", "prompts"))
    words = [p.replace("[", "").replace("]", "") for pair in pool for p in pair[:2]]
    return write_vocab(os.path.join(root, "tokenizer"), words)
