"""InstructDiffusion multi-task training datasets (seg / pose / low-level): the
port's own copy of ``pnpinversion_tpu/training/multitask.py`` (host numpy and
PIL; given the same ``np.random.Generator`` each returns the very same arrays).
Counterparts of the reference's multi-task loaders:

- ``SegmentationPaintDataset`` ≙ dataset/seg/coco_stuff.py (square-crop +
  LANCZOS resize, NEAREST label resize :95-115; random present label or,
  with ``empty_percentage``, an absent one -> "leave the picture as it is."
  :130-152; alpha-blend mask painting :156-160; {color}/{object} prompt
  templates from dataset/prompt/prompt_seg.txt).
- ``KeypointCircleDataset`` ≙ dataset/pose/pose.py:220-278 (random subset of
  visible joints, filled circles of radius r alpha-blended in per-joint
  colors, concatenated {color}/{joint} prompt templates). The COCO
  annotation plumbing is replaced by a documented keypoints.json layout —
  the reference's 500 lines of COCO/zip bookkeeping are dataset-specific
  I/O, not semantics.
- ``PairedRestorationDataset`` ≙ dataset/low_level/lowlevel_{gopro,reds,
  sidd,clwd}.py (sorted input/target dirs, aspect-preserving short-side
  resize, shared random crop + flip, per-task fixed prompt list,
  ``sample_weight`` length scaling :68-74, optional "Task: " instruct
  prefix).

All loaders are host-side numpy (the device step consumes fixed-shape
batches) and return the ``EditPairDataset`` example dict
``{"cond_image", "edited", "edit"}`` (NHWC float32 in [-1, 1]) so they drop
straight into ``training.data.WeightedConcat`` and ``EditTrainer``.

Prompt template sets are small built-in equivalents of the reference's
dataset/prompt/*.txt lists (same placeholders); pass ``prompt_file`` to use
a full external list.
"""
from __future__ import annotations

import json
import os
from glob import glob
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

# name -> RGB, a compact stand-in for dataset/prompt/color_list_train_small.txt
COLORS: Dict[str, Tuple[int, int, int]] = {
    "red": (255, 0, 0),
    "green": (0, 128, 0),
    "blue": (0, 0, 255),
    "yellow": (255, 255, 0),
    "purple": (128, 0, 128),
    "orange": (255, 165, 0),
    "cyan": (0, 255, 255),
    "magenta": (255, 0, 255),
    "white": (255, 255, 255),
    "black": (0, 0, 0),
}

SEG_PROMPTS = (
    "Mark the pixels of {object} in {color} and leave the rest unchanged.",
    "Paint every pixel of the {object} {color}, keeping all other pixels as they are.",
    "Color the {object} {color} without touching anything else in the picture.",
    "Fill the region of the {object} with {color}, preserving the rest of the image.",
)

POSE_PROMPTS = (
    "Circle the {joint} of the people with the color {color}, ",
    "Draw a {color} circle around the {joint} of the people, ",
    "Mark the {joint} of the people with a {color} circle, ",
)

RESTORATION_PROMPTS: Dict[str, Sequence[str]] = {
    "deblur": ("Sharpen this blurry image",
               "Remove the blur from this picture",
               "Bring this out-of-focus photo into focus"),
    "denoise": ("Remove noise from this image",
                "Clean the grain out of this photograph",
                "Denoise this picture"),
    "dewatermark": ("Remove watermark from this picture",
                    "Erase the watermark from this photograph",
                    "Delete the watermark overlay from this image"),
}


def _load_prompt_file(path: str) -> List[str]:
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def _to_example(img0: np.ndarray, img1: np.ndarray, prompt: str) -> Dict[str, Any]:
    to_f32 = lambda a: a.astype(np.float32) / 127.5 - 1.0
    return {"cond_image": to_f32(img0), "edited": to_f32(img1), "edit": prompt}


def _square_crop_resize(image: np.ndarray, label: np.ndarray, res: int,
                        rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """coco_stuff.py:97-115: random square crop along the long axis, then
    LANCZOS (image) / NEAREST (label) resize to res."""
    h, w = label.shape
    if h > w:
        y = int(rng.integers(0, h - w + 1))
        image, label = image[y:y + w], label[y:y + w]
    elif w > h:
        x = int(rng.integers(0, w - h + 1))
        image, label = image[:, x:x + h], label[:, x:x + h]
    image = np.asarray(Image.fromarray(image).resize(
        (res, res), Image.Resampling.LANCZOS), np.uint8)
    label = np.asarray(Image.fromarray(label).resize(
        (res, res), Image.Resampling.NEAREST), np.int64)
    return image, label


class SegmentationPaintDataset:
    """COCO-Stuff-layout segmentation-painting task.

    Layout: ``<path>/images/<split>/<id>.jpg`` + grayscale label maps
    ``<path>/annotations/<split>/<id>.png`` + ``<path>/labels.txt``
    ("<idx>: <name>" per line, 1-based like the reference's labels file).
    """

    def __init__(self, path: str, split: str = "train2017", crop_res: int = 256,
                 flip_prob: float = 0.0, transparency: float = 0.0,
                 empty_percentage: float = 0.0, num_labels: int = 182,
                 prompt_file: Optional[str] = None):
        self.path, self.split = path, split
        self.crop_res, self.flip_prob = crop_res, flip_prob
        self.transparency, self.empty_percentage = transparency, empty_percentage
        self.num_labels = num_labels
        files = sorted(glob(os.path.join(path, "images", split, "*.jpg")))
        assert files, f"{os.path.join(path, 'images', split)} has no image"
        self.files = [os.path.basename(f)[:-4] for f in files]
        self.prompts = (_load_prompt_file(prompt_file) if prompt_file
                        else list(SEG_PROMPTS))
        self.label_names: Dict[int, str] = {}
        with open(os.path.join(path, "labels.txt")) as f:
            for line in f:
                if ": " in line:
                    k, v = line.strip().split(": ", 1)
                    self.label_names[int(k)] = v

    def __len__(self) -> int:
        return len(self.files)

    def get(self, i: int, rng: np.random.Generator) -> Dict[str, Any]:
        name = self.files[i]
        image = np.asarray(Image.open(os.path.join(
            self.path, "images", self.split, name + ".jpg")).convert("RGB"))
        label = np.asarray(Image.open(os.path.join(
            self.path, "annotations", self.split, name + ".png")).convert("L"))
        image, label = _square_crop_resize(image, label, self.crop_res, rng)

        present = [int(v) for v in np.unique(label) if v != 255]
        if present:
            label_idx = int(rng.choice(present))
            if rng.random() < self.empty_percentage:
                absent = [v for v in range(self.num_labels) if v not in present]
                if absent:
                    label_idx = int(rng.choice(absent))
            class_name = self.label_names[label_idx + 1]
            color_name = list(COLORS)[int(rng.integers(0, len(COLORS)))]
            prompt = self.prompts[int(rng.integers(0, len(self.prompts)))].format(
                color=color_name.lower(), object=class_name.lower())
            rgb = COLORS[color_name]
        else:
            label_idx, prompt, rgb = 200, "leave the picture as it is.", (0, 0, 0)

        mask = label == label_idx
        edited = image.astype(np.float32).copy()
        if present:
            t = self.transparency
            edited[mask] = t * edited[mask] + (1 - t) * np.asarray(rgb, np.float32)
        edited = edited.round().clip(0, 255).astype(np.uint8)

        if rng.random() < self.flip_prob:
            image, edited = image[:, ::-1], edited[:, ::-1]
        return _to_example(image, edited, prompt)


class KeypointCircleDataset:
    """Pose keypoint-marking task over a documented json layout.

    Layout: ``<path>/keypoints.json`` =
    ``[{"image": rel_path, "joints": [[x, y, v], ...]}, ...]`` with joint
    order named by ``joint_names`` (COCO-17 by default); images under
    ``<path>/``. Target-generation semantics of pose.py:220-278.
    """

    COCO_JOINTS = ("nose", "left eye", "right eye", "left ear", "right ear",
                   "left shoulder", "right shoulder", "left elbow",
                   "right elbow", "left wrist", "right wrist", "left hip",
                   "right hip", "left knee", "right knee", "left ankle",
                   "right ankle")

    def __init__(self, path: str, crop_res: int = 256, flip_prob: float = 0.0,
                 radius: int = 10, transparency: float = 0.0,
                 min_prompt_num: int = 1, max_prompt_num: int = 5,
                 joint_names: Sequence[str] = COCO_JOINTS,
                 prompt_file: Optional[str] = None):
        self.path, self.crop_res, self.flip_prob = path, crop_res, flip_prob
        self.radius, self.transparency = radius, transparency
        self.min_prompt_num, self.max_prompt_num = min_prompt_num, max_prompt_num
        self.joint_names = tuple(joint_names)
        self.prompts = (_load_prompt_file(prompt_file) if prompt_file
                        else list(POSE_PROMPTS))
        with open(os.path.join(path, "keypoints.json")) as f:
            self.items = json.load(f)

    def __len__(self) -> int:
        return len(self.items)

    def get(self, i: int, rng: np.random.Generator) -> Dict[str, Any]:
        item = self.items[i]
        res = self.crop_res
        image = np.asarray(Image.open(os.path.join(
            self.path, item["image"])).convert("RGB"))
        h, w = image.shape[:2]
        joints = np.asarray(item["joints"], np.float32).reshape(-1, 3).copy()
        # scale to the crop resolution (the reference warps via an affine
        # transform to image_size; plain resize keeps the same geometry here)
        image = np.asarray(Image.fromarray(image).resize(
            (res, res), Image.Resampling.LANCZOS), np.uint8)
        joints[:, 0] *= res / w
        joints[:, 1] *= res / h

        n = int(rng.integers(self.min_prompt_num,
                             min(self.max_prompt_num, len(joints)) + 1))
        joint_ids = rng.choice(len(joints), size=n, replace=False)
        color_names = [list(COLORS)[j] for j in
                       rng.choice(len(COLORS), size=n, replace=False)]

        target = image.astype(np.float32).copy()
        prompt = ""
        r = self.radius
        yy, xx = np.indices((2 * r + 1, 2 * r + 1))
        disk = (xx - r) ** 2 + (yy - r) ** 2 <= r ** 2 + 1
        for color_name, jid in zip(color_names, joint_ids):
            x, y, v = joints[int(jid)]
            mu_x, mu_y = int(x + 0.5), int(y + 0.5)
            ul = (mu_x - r, mu_y - r)
            br = (mu_x + r + 1, mu_y + r + 1)
            if ul[0] >= res or ul[1] >= res or br[0] < 0 or br[1] < 0:
                continue  # pose.py:245-249 — skip out-of-bounds joints
            prompt += self.prompts[int(rng.integers(0, len(self.prompts)))].format(
                color=color_name, joint=self.joint_names[int(jid)])
            if v <= 0.5:
                continue  # named in the prompt but not drawn (pose.py:266-276)
            gx = (max(0, -ul[0]), min(br[0], res) - ul[0])
            gy = (max(0, -ul[1]), min(br[1], res) - ul[1])
            ix = (max(0, ul[0]), min(br[0], res))
            iy = (max(0, ul[1]), min(br[1], res))
            sub = target[iy[0]:iy[1], ix[0]:ix[1]]
            m = disk[gy[0]:gy[1], gx[0]:gx[1]]
            t = self.transparency
            sub[m] = t * sub[m] + (1 - t) * np.asarray(COLORS[color_name], np.float32)
        target = target.round().clip(0, 255).astype(np.uint8)

        if rng.random() < self.flip_prob:
            image, target = image[:, ::-1], target[:, ::-1]
        return _to_example(image, target, prompt)


class PairedRestorationDataset:
    """Low-level (degraded -> clean) pair task: deblur / denoise / dewatermark.

    Layout of lowlevel_{gopro,reds,sidd,clwd}.py: sorted
    ``<path>/<split>/input/*`` and ``<path>/<split>/target/*`` image pairs.
    """

    def __init__(self, path: str, task: str = "deblur", split: str = "train",
                 size: int = 256, flip_prob: float = 0.5,
                 sample_weight: float = 1.0, instruct: bool = False,
                 prompt_file: Optional[str] = None):
        exts = (".jpg", ".jpeg", ".png", ".gif", ".JPG", ".JPEG", ".PNG")
        list_dir = lambda sub: sorted(
            os.path.join(path, split, sub, f)
            for f in os.listdir(os.path.join(path, split, sub))
            if f.endswith(exts))
        self.inp_files = list_dir("input")
        self.tar_files = list_dir("target")
        assert len(self.inp_files) == len(self.tar_files) and self.inp_files
        self.task, self.size, self.flip_prob = task, size, flip_prob
        self.sample_weight, self.instruct = sample_weight, instruct
        self.prompts = (_load_prompt_file(prompt_file) if prompt_file
                        else list(RESTORATION_PROMPTS[task]))

    def __len__(self) -> int:
        # lowlevel_gopro.py:67-68: sample_weight scales the epoch length
        return int(len(self.inp_files) * self.sample_weight)

    def get(self, i: int, rng: np.random.Generator) -> Dict[str, Any]:
        n = len(self.inp_files)
        if self.sample_weight >= 1:
            idx = i % n  # oversample by wrapping (lowlevel_gopro.py:71-72)
        else:  # undersample: each index covers a 1/weight-wide stride (:73-74)
            stride = int(1 / self.sample_weight)
            idx = min(int(i / self.sample_weight) + int(rng.integers(0, stride)),
                      n - 1)
        inp = Image.open(self.inp_files[idx]).convert("RGB")
        tar = Image.open(self.tar_files[idx]).convert("RGB")
        assert inp.size == tar.size, "Input and target image mismatch"
        w, h = inp.size
        # aspect-preserving short-side resize to self.size (:85-93)
        if w < h:
            nw, nh = self.size, int(self.size * h / w)
        else:
            nh, nw = self.size, int(self.size * w / h)
        inp = np.asarray(inp.resize((nw, nh), Image.Resampling.LANCZOS))
        tar = np.asarray(tar.resize((nw, nh), Image.Resampling.LANCZOS))

        s = self.size
        y = int(rng.integers(0, nh - s + 1))
        x = int(rng.integers(0, nw - s + 1))
        inp, tar = inp[y:y + s, x:x + s], tar[y:y + s, x:x + s]
        if rng.random() < self.flip_prob:
            inp, tar = inp[:, ::-1], tar[:, ::-1]

        prompt = self.prompts[int(rng.integers(0, len(self.prompts)))]
        if self.instruct:
            prompt = f"Image {self.task.capitalize()}: {prompt}"
        return _to_example(inp, tar, prompt)
