"""Edit-pair training data: the InstructPix2Pix generated-dataset layout
(the port's own copy of ``pnpinversion_tpu/training/data.py``: host numpy
and PIL, no torch; given the same ``np.random.Generator`` it gives the very
same arrays).

Layout (models/instructpix2pix/edit_dataset.py:16-72):

    <root>/seeds.json                 # [[name, [seed, ...]], ...]
    <root>/<name>/prompt.json         # {"input":..., "edit":..., "output":...}
    <root>/<name>/<seed>_0.jpg        # source image
    <root>/<name>/<seed>_1.jpg        # edited image

Split fractions use the reference's floor arithmetic (edit_dataset.py:38-46)
so a given dataset partitions identically. Augmentation (random resize in
[min,max], shared random crop, shared horizontal flip) is host-side numpy —
the device step consumes fixed-shape batches. Images are NHWC float32 in
[-1, 1] (the reference's CHW is a torch convention).

``WeightedConcat`` mirrors the InstructDiffusion multi-task loader's
per-dataset sample weights (models/InstructDiffusion/main.py:211-242,
dataset/ concat with sample_weight): each draw picks a dataset by weight,
then a uniform item within it.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

SPLITS = (0.9, 0.05, 0.05)


def split_bounds(n: int, split: str, splits: Sequence[float] = SPLITS) -> Tuple[int, int]:
    """Reference floor arithmetic (edit_dataset.py:38-46)."""
    assert split in ("train", "val", "test"), split
    lo = {"train": 0.0, "val": splits[0], "test": splits[0] + splits[1]}[split]
    hi = {"train": splits[0], "val": splits[0] + splits[1], "test": 1.0}[split]
    return math.floor(lo * n), math.floor(hi * n)


class EditPairDataset:
    """One ip2p-format dataset directory."""

    def __init__(
        self,
        path: str,
        split: str = "train",
        splits: Sequence[float] = SPLITS,
        min_resize_res: int = 256,
        max_resize_res: int = 256,
        crop_res: int = 256,
        flip_prob: float = 0.0,
    ):
        assert abs(sum(splits) - 1.0) < 1e-9, splits
        self.path = path
        self.min_resize_res = min_resize_res
        self.max_resize_res = max_resize_res
        self.crop_res = crop_res
        self.flip_prob = flip_prob
        with open(os.path.join(path, "seeds.json")) as f:
            seeds = json.load(f)
        lo, hi = split_bounds(len(seeds), split, splits)
        self.seeds: List[Tuple[str, List[Any]]] = [tuple(s) for s in seeds[lo:hi]]

    def __len__(self) -> int:
        return len(self.seeds)

    def get(self, i: int, rng: np.random.Generator) -> Dict[str, Any]:
        """One augmented example: NHWC float32 [-1,1] images + the edit
        instruction string (edit_dataset.py:51-72 semantics)."""
        name, seeds = self.seeds[i]
        item_dir = os.path.join(self.path, name)
        seed = seeds[int(rng.integers(0, len(seeds)))]
        with open(os.path.join(item_dir, "prompt.json")) as fp:
            prompt = json.load(fp)["edit"]

        res = int(rng.integers(self.min_resize_res, self.max_resize_res + 1))
        img0 = Image.open(os.path.join(item_dir, f"{seed}_0.jpg")).convert("RGB")
        img1 = Image.open(os.path.join(item_dir, f"{seed}_1.jpg")).convert("RGB")
        img0 = np.asarray(img0.resize((res, res), Image.Resampling.LANCZOS))
        img1 = np.asarray(img1.resize((res, res), Image.Resampling.LANCZOS))

        # shared crop + flip for the pair (edit_dataset.py:68-70)
        c = self.crop_res
        y = int(rng.integers(0, res - c + 1))
        x = int(rng.integers(0, res - c + 1))
        img0, img1 = img0[y : y + c, x : x + c], img1[y : y + c, x : x + c]
        if rng.random() < self.flip_prob:
            img0, img1 = img0[:, ::-1], img1[:, ::-1]

        to_f32 = lambda a: a.astype(np.float32) / 127.5 - 1.0
        return {"cond_image": to_f32(img0), "edited": to_f32(img1), "edit": prompt}


class WeightedConcat:
    """InstructDiffusion-style multi-task mixture: draw a dataset by weight,
    then a uniform item within it. Weight 1.0 each == uniform-over-datasets
    (NOT size-proportional — the reference oversamples small task datasets
    the same way)."""

    def __init__(self, datasets: Sequence[EditPairDataset],
                 weights: Optional[Sequence[float]] = None):
        assert datasets
        w = np.asarray(weights if weights is not None else [1.0] * len(datasets),
                       np.float64)
        assert w.shape == (len(datasets),) and (w > 0).all()
        # drop empty datasets (e.g. a val split too small to get any items
        # under the floor arithmetic) so sample() can't draw from them
        keep = [i for i, d in enumerate(datasets) if len(d) > 0]
        self.datasets = [datasets[i] for i in keep]
        w = w[keep]
        self.p = w / w.sum() if len(w) else w

    def __len__(self) -> int:
        return sum(len(d) for d in self.datasets)

    def sample(self, rng: np.random.Generator) -> Dict[str, Any]:
        if not self.datasets:
            raise ValueError("all datasets in the mixture are empty")
        ds = self.datasets[int(rng.choice(len(self.datasets), p=self.p))]
        return ds.get(int(rng.integers(0, len(ds))), rng)


def batches(
    source,
    batch_size: int,
    *,
    seed: int = 0,
    process_count: int = 1,
    process_index: int = 0,
    num_batches: Optional[int] = None,
) -> Iterator[Dict[str, Any]]:
    """Infinite (or bounded) stream of host batches.

    Each process draws from a process-disjoint RNG stream — the multi-host
    sharding contract (every host feeds its local chips; no global shuffle
    state to coordinate, matching the sweep's process-sharded design).
    Yields {"cond_image": (B,H,W,3) f32, "edited": (B,H,W,3) f32,
    "edit": [str]*B}.
    """
    if isinstance(source, EditPairDataset):
        source = WeightedConcat([source])
    rng = np.random.default_rng(np.random.SeedSequence([seed, process_index]))
    n = 0
    while num_batches is None or n < num_batches:
        items = [source.sample(rng) for _ in range(batch_size)]
        yield {
            "cond_image": np.stack([it["cond_image"] for it in items]),
            "edited": np.stack([it["edited"] for it in items]),
            "edit": [it["edit"] for it in items],
        }
        n += 1
    _ = process_count  # signature parity; streams are independent per process
