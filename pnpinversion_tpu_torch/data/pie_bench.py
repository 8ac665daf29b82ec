"""PIE-Bench data layer (port of ``pnpinversion_tpu/data/pie_bench.py``):
the mapping-file reader, the RLE mask codec and image loading, in numpy and
PIL. The port's own copy: it imports nothing of the JAX package.

The mask decode keeps the JAX package's semantics (an f64 buffer, runs cut at
the end of the image, the boundary rows and columns forced to 1). At the JAX
package's threshold, 4096 pixels and more, it takes the C++ decoder
(``data/_native.py``, built at first use; a failed build raises); below it,
the numpy loop, which is also the decoder's plain version.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
from PIL import Image

from pnpinversion_tpu_torch.data import _native

NATIVE_MIN_PIXELS = 4096  # the JAX package's threshold for its C++ decoder


def rle_decode_reference(enc: np.ndarray, length: int) -> np.ndarray:
    """The decode's plain version: [start, len] pairs (n, 2) -> a flat
    {0, 1} f64 mask, each run cut at the end."""
    mask = np.zeros((length,), dtype=np.float64)
    for start, run in enc:
        splice = min(int(run), length - int(start))
        if splice > 0:
            mask[start : start + splice] = 1
    return mask


def mask_decode(encoded_mask: Sequence[int], image_shape=(512, 512)) -> np.ndarray:
    """Decode [start0, len0, start1, len1, ...] run-length pairs to a {0, 1}
    f64 mask. The boundary rows and columns are forced to 1, the reference
    harness's workaround for annotation errors."""
    length = image_shape[0] * image_shape[1]
    enc = np.asarray(encoded_mask, dtype=np.int64).reshape(-1, 2)
    mask = (_native.rle_decode(enc, length) if length >= NATIVE_MIN_PIXELS
            else rle_decode_reference(enc, length))
    mask = mask.reshape(image_shape[0], image_shape[1])
    mask[0, :] = 1
    mask[-1, :] = 1
    mask[:, 0] = 1
    mask[:, -1] = 1
    return mask


def mask_encode(mask: np.ndarray) -> List[int]:
    """Inverse of ``mask_decode`` (up to the forced boundary): flat RLE pairs."""
    flat = np.asarray(mask).reshape(-1).astype(bool)
    diff = np.diff(np.concatenate([[False], flat, [False]]).astype(np.int8))
    starts, ends = np.where(diff == 1)[0], np.where(diff == -1)[0]
    out: List[int] = []
    for s, e in zip(starts, ends):
        out.extend([int(s), int(e - s)])
    return out


def load_image(image_path, size: int = 512, left=0, right=0, top=0, bottom=0) -> np.ndarray:
    """Crop to a square, then resize to size x size RGB uint8."""
    if isinstance(image_path, str):
        image = np.array(Image.open(image_path))[:, :, :3]
    else:
        image = np.asarray(image_path)
    h, w, _ = image.shape
    left = min(left, w - 1)
    right = min(right, w - left - 1)
    top = min(top, h - left - 1)
    bottom = min(bottom, h - top - 1)
    image = image[top : h - bottom, left : w - right]
    h, w, _ = image.shape
    if h < w:
        offset = (w - h) // 2
        image = image[:, offset : offset + h]
    elif w < h:
        offset = (h - w) // 2
        image = image[offset : offset + w]
    if image.shape[:2] != (size, size):
        image = np.array(Image.fromarray(image).resize((size, size)))
    return image


def load_512(image_path, left=0, right=0, top=0, bottom=0) -> np.ndarray:
    """Crop to a square, then resize to 512 x 512 RGB uint8."""
    return load_image(image_path, 512, left, right, top, bottom)


@dataclasses.dataclass(frozen=True)
class PieBenchItem:
    """One annotated PIE-Bench example."""

    key: str
    image_path: str
    original_prompt: str
    editing_prompt: str
    editing_instruction: str
    editing_type_id: str
    blended_word: List[str]
    mask: np.ndarray
    # TI2I items carry a list of target prompts per image; prompt_index tells
    # their outputs apart (None for plain PIE-Bench items)
    prompt_index: Optional[int] = None

    @property
    def source_prompt(self) -> str:
        return self.original_prompt.replace("[", "").replace("]", "")

    @property
    def target_prompt(self) -> str:
        return self.editing_prompt.replace("[", "").replace("]", "")

    def rel_output_path(self, images_root: str) -> str:
        """Output path relative to the method folder: the input's relative
        path, suffixed ``_<prompt_index>`` before the extension for TI2I items
        so that one image's per-prompt edits do not collide."""
        rel = os.path.relpath(self.image_path, images_root)
        if self.prompt_index is not None:
            stem, ext = os.path.splitext(rel)
            rel = f"{stem}_{self.prompt_index}{ext}"
        return rel


class PieBenchDataset:
    """``mapping_file.json`` reader with the category filter and the
    idempotent skip-existing contract of the sweep.

    Also reads the TI2I benchmark's mapping (``mapping_file=``): its items
    carry only an image and target prompt(s), so category ("ti2i"), source
    prompt ("") and mask (zeros) default, the category filter passes them,
    and a list of editing prompts yields one item per prompt (key suffixed
    ``_0``, ``_1``, ...).
    """

    def __init__(self, data_path: str, mapping_file: Optional[str] = None):
        self.data_path = data_path
        mapping_file = mapping_file or os.path.join(data_path, "mapping_file.json")
        with open(mapping_file) as f:
            self.mapping: Dict[str, dict] = json.load(f)

    def __len__(self) -> int:
        return len(self.mapping)

    def items(self, edit_category_list: Optional[Sequence[str]] = None) -> Iterator[PieBenchItem]:
        for key, item in self.mapping.items():
            cat = item.get("editing_type_id")
            if (cat is not None and edit_category_list is not None
                    and cat not in edit_category_list):
                continue
            blended = item.get("blended_word", "")
            blended_words = blended.split(" ") if blended != "" else []
            mask = mask_decode(item["mask"]) if "mask" in item else np.zeros((512, 512))
            prompts = item.get("editing_prompt", "")
            many = isinstance(prompts, (list, tuple))
            for pi, prompt in enumerate(prompts if many else [prompts]):
                yield PieBenchItem(
                    key=f"{key}_{pi}" if many else key,
                    image_path=os.path.join(self.data_path, "annotation_images",
                                            item["image_path"]),
                    original_prompt=item.get("original_prompt", ""),
                    editing_prompt=prompt,
                    editing_instruction=item.get("editing_instruction", ""),
                    editing_type_id=cat if cat is not None else "ti2i",
                    blended_word=blended_words,
                    mask=mask,
                    prompt_index=pi if many else None,
                )

    @staticmethod
    def output_path(output_dir: str, method_folder: str, item: "PieBenchItem",
                    rel_image_path: str) -> str:
        return os.path.join(output_dir, "annotation_images", method_folder, rel_image_path)

    @staticmethod
    def should_skip(path: str, rerun_exist_images: bool) -> bool:
        return os.path.exists(path) and not rerun_exist_images
