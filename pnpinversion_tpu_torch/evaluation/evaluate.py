"""Evaluation CLI (port of ``pnpinversion_tpu/evaluation/evaluate.py``), with
the reference's CSV schema: a ``file_id`` column, then one ``{method}|{metric}``
column per method folder and metric, one row per (image, target prompt),
"nan" where a metric is undefined (an empty or full mask, a TI2I item
without mask or source prompt), and the edit panel cropped from the last
512 columns of the 4-panel strips.

    python -m pnpinversion_tpu_torch.evaluation.evaluate --device cuda \\
        --annotation_mapping_file data/mapping_file.json \\
        --tgt_methods 1_directinversion+p2p

It runs on the card unless ``--device cpu`` is given; without CUDA and
without ``--device cpu`` it raises. ``--sharded`` scores ``--batch_size``
images a step (one per device by default) with ``evaluation.sharded``'s
batched metrics over every GPU of the host (the device metrics only, as in
the JAX package), and writes the same CSV, rewritten as each method folder
completes; an unreadable target is "nan" there rather than an error. Not
ported: the JAX package's retry on a TPU out-of-memory error.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from pnpinversion_tpu_torch.data.pie_bench import mask_decode

DEFAULT_METRICS = [
    "structure_distance",
    "psnr_unedit_part",
    "lpips_unedit_part",
    "mse_unedit_part",
    "ssim_unedit_part",
    "clip_similarity_source_image",
    "clip_similarity_target_image",
    "clip_similarity_target_image_edit_part",
]

# the reference evaluator's registry: method key -> output folder
_METHODS_1 = [
    "ddim+p2p", "null-text-inversion+p2p_a800", "null-text-inversion+p2p_3090",
    "negative-prompt-inversion+p2p", "stylediffusion+p2p", "directinversion+p2p",
    "ddim+masactrl", "directinversion+masactrl",
    "ddim+pix2pix-zero", "directinversion+pix2pix-zero",
    "ddim+pnp", "directinversion+pnp",
]
_METHODS_2 = ["instruct-pix2pix", "instruct-diffusion", "blended-latent-diffusion",
              "directinversion+p2p"]
_GUIDANCE = [f"directinversion+p2p_guidance_{a}_{b}"
             for a in ("0", "1", "25", "5", "75") for b in ("1", "5", "25", "75")]
_METHODS_4 = ["null-text-inversion+proximal-guidance",
              "negative-prompt-inversion+proximal-guidance",
              "edit-friendly-inversion+p2p", "edict+direct_forward", "edict+p2p",
              "directinversion+p2p"]
_METHODS_5 = ["ablation_directinversion_04+p2p", "ablation_directinversion_08+p2p",
              "ablation_null-latent-inversion+p2p_a800",
              "ablation_null-latent-inversion+p2p_3090",
              "ablation_null-text-inversion_single_branch+p2p_a800",
              "ablation_null-text-inversion_single_branch+p2p_3090"]
_METHODS_6 = [f"ablation_directinversion_interval_{k}+p2p" for k in (2, 5, 10, 24, 49)]
_METHODS_7 = [f"ablation_directinversion_step_{k}+p2p" for k in (20, 100, 500)]
_METHODS_8 = ["ablation_directinversion_add-source+p2p",
              "ablation_directinversion_add-target+p2p"]


def all_tgt_image_folders(output_root: str = "output") -> Dict[str, str]:
    reg: Dict[str, str] = {}
    for group, methods in [("1", _METHODS_1), ("2", _METHODS_2), ("3", _GUIDANCE),
                           ("4", _METHODS_4), ("5", _METHODS_5), ("6", _METHODS_6),
                           ("7", _METHODS_7), ("8", _METHODS_8)]:
        for m in methods:
            key = f"{group}_{m}"
            if group in ("6", "7"):  # these groups key without the +p2p suffix
                key = f"{group}_{m.replace('+p2p', '')}"
            reg[key] = os.path.join(output_root, m, "annotation_images")
    # group 4's older keys for the null-text rows
    for run in ("a800", "3090"):
        reg[f"4_null-text-inverse+p2p_{run}"] = os.path.join(
            output_root, f"null-text-inversion+p2p_{run}", "annotation_images")
    # the StyleDiffusion runner writes to the reference's misspelt folder
    # 'styleidffusion+p2p' while the registry reads the right name: read the
    # misspelt one when only it exists, so that sweep -> evaluate round-trips
    canon = reg["1_stylediffusion+p2p"]
    typo = os.path.join(output_root, "styleidffusion+p2p", "annotation_images")
    if not os.path.isdir(canon) and os.path.isdir(typo):
        reg["1_stylediffusion+p2p"] = typo
    return reg


def calculate_metric(calc, metric: str, src_image, tgt_image, src_mask, tgt_mask,
                     src_prompt: str, tgt_prompt: str):
    """One metric of one image pair, with the reference's "nan" sentinels
    for an empty or full mask."""
    if metric in ("psnr", "lpips", "mse", "ssim", "structure_distance"):
        return getattr(calc, f"calculate_{metric}")(src_image, tgt_image, None, None)
    for name in ("psnr", "lpips", "mse", "ssim", "structure_distance"):
        if metric == f"{name}_unedit_part":
            if (1 - src_mask).sum() == 0 or (1 - tgt_mask).sum() == 0:
                return "nan"
            return getattr(calc, f"calculate_{name}")(
                src_image, tgt_image, 1 - src_mask, 1 - tgt_mask)
        if metric == f"{name}_edit_part":
            if src_mask.sum() == 0 or tgt_mask.sum() == 0:
                return "nan"
            return getattr(calc, f"calculate_{name}")(src_image, tgt_image, src_mask, tgt_mask)
    if metric == "clip_similarity_source_image":
        return calc.calculate_clip_similarity(src_image, src_prompt, None)
    if metric == "clip_similarity_target_image":
        return calc.calculate_clip_similarity(tgt_image, tgt_prompt, None)
    if metric == "clip_similarity_target_image_edit_part":
        if tgt_mask.sum() == 0:
            return "nan"
        return calc.calculate_clip_similarity(tgt_image, tgt_prompt, tgt_mask)
    raise ValueError(f"unknown metric {metric!r}")


def crop_edit_panel(img: Image.Image, panel: Optional[int] = None) -> Image.Image:
    """The edit, the last of a strip's square panels (``panel`` wide, the
    strip's height by default); a square image is returned as it is."""
    if img.size[0] != img.size[1]:
        panel = panel or img.size[1]
        img = img.crop((img.size[0] - panel, img.size[1] - panel, img.size[0], img.size[1]))
    return img


def _nan_sentinel(metric: str, mask: np.ndarray, has_mask: bool = True,
                  src_prompt: str = " ") -> bool:
    """Whether a metric is "nan" for this item: the reference's rules, and
    for TI2I items (no mask, no source prompt) every masked metric and the
    source image's CLIP similarity."""
    if metric.endswith("_unedit_part"):
        return not has_mask or (1 - mask).sum() == 0
    if metric.endswith("_edit_part"):
        return not has_mask or mask.sum() == 0
    if metric == "clip_similarity_source_image":
        return src_prompt.strip() == ""
    return False


def _normalized_items(annotation: Dict, edit_category_list: Sequence[str]):
    """One evaluation row per (image, target prompt): dicts of ``file_id``,
    ``src_path`` (relative to the inputs), ``tgt_path`` (relative to a method
    folder), ``src_prompt``, ``tgt_prompt``, ``mask`` (H, W, 3) and
    ``has_mask``. TI2I items pass the category filter, have no mask and no
    source prompt, and may carry a list of prompts: one row each, with
    ``file_id`` and the target's file name suffixed ``_<i>`` as
    ``PieBenchItem.rel_output_path`` names them."""
    for key, item in annotation.items():
        cat = item.get("editing_type_id")
        if cat is not None and cat not in edit_category_list:
            continue
        has_mask = "mask" in item
        mask = (mask_decode(item["mask"]) if has_mask
                else np.zeros((512, 512)))[:, :, np.newaxis].repeat(3, axis=2)
        src_prompt = item.get("original_prompt", "").replace("[", "").replace("]", "")
        prompts = item.get("editing_prompt", "")
        many = isinstance(prompts, (list, tuple))
        for pi, prompt in enumerate(prompts if many else [prompts]):
            tgt_path = item["image_path"]
            if many:
                stem, ext = os.path.splitext(tgt_path)
                tgt_path = f"{stem}_{pi}{ext}"
            yield {
                "file_id": f"{key}_{pi}" if many else key,
                "src_path": item["image_path"],
                "tgt_path": tgt_path,
                "src_prompt": src_prompt,
                "tgt_prompt": str(prompt).replace("[", "").replace("]", ""),
                "mask": mask,
                "has_mask": has_mask,
            }


def _evaluate_sharded(annotation: Dict, metrics: List[str], src_image_folder: str,
                      tgt_image_folders: Dict[str, str], result_path: str,
                      edit_category_list: Sequence[str], calc,
                      batch_size: Optional[int]) -> None:
    """The batched evaluation: the serial path's CSV, ``batch_size`` items a
    step (the device count by default) through ``ShardedEvaluator`` on every
    GPU of the host when the calculator is on one, else on its device."""
    import torch

    from pnpinversion_tpu_torch.evaluation.sharded import ShardedEvaluator

    ev = ShardedEvaluator(calc, [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                          if calc.device.type == "cuda" else None)
    batch_size = batch_size or len(ev.devices)
    loaded = []
    for it in _normalized_items(annotation, edit_category_list):
        it["src"] = np.array(Image.open(os.path.join(src_image_folder, it["src_path"])))
        loaded.append(it)
    results: Dict[tuple, object] = {}
    for fkey, folder in tgt_image_folders.items():
        for lo in range(0, len(loaded), batch_size):
            chunk = loaded[lo: lo + batch_size]
            # a missing or corrupt target (a half-finished sweep) must not lose
            # the rest: a blank image keeps the batch, and its cells are "nan"
            tgts, bad = [], set()
            for i, it in enumerate(chunk):
                try:
                    tgts.append(np.asarray(crop_edit_panel(Image.open(
                        os.path.join(folder, it["tgt_path"])))))
                except Exception as exc:  # noqa: BLE001 - one item's target, reported
                    print(f"eval: unreadable target {fkey}/{it['tgt_path']}: {exc!r}")
                    tgts.append(np.zeros_like(it["src"]))
                    bad.add(i)
            out = ev.evaluate_batch(metrics, np.stack([it["src"] for it in chunk]),
                                    np.stack(tgts), np.stack([it["mask"] for it in chunk]),
                                    [it["src_prompt"] for it in chunk],
                                    [it["tgt_prompt"] for it in chunk])
            for i, it in enumerate(chunk):
                for m in metrics:
                    results[(it["file_id"], fkey, m)] = (
                        "nan" if i in bad or _nan_sentinel(m, it["mask"], it["has_mask"],
                                                           it["src_prompt"])
                        else float(out[m][i]))
        # the CSV rewritten as each folder completes: a crash later keeps this work
        _flush_sharded_rows(result_path, results, [it["file_id"] for it in loaded],
                            tgt_image_folders, metrics)


def _flush_sharded_rows(result_path: str, results: Dict[tuple, object], file_ids: List[str],
                        tgt_image_folders: Dict[str, str], metrics: List[str]) -> None:
    """Rewrites the CSV from the results so far, one row per item; cells not
    scored yet are "nan"."""
    head = [f"{key}|{m}" for key in tgt_image_folders for m in metrics]
    with open(result_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file_id"] + head)
        for fid in file_ids:
            w.writerow([fid] + [results.get((fid, fkey, m), "nan")
                                for fkey in tgt_image_folders for m in metrics])


def evaluate(annotation_mapping_file: str, metrics: List[str], src_image_folder: str,
             tgt_image_folders: Dict[str, str], result_path: str,
             edit_category_list: Sequence[str], calc=None, sharded: bool = False,
             batch_size: Optional[int] = None) -> None:
    """Scores every item of the mapping file in every method folder and
    writes the CSV, a row per item as soon as it is scored (``sharded``:
    ``batch_size`` items a step, ``_evaluate_sharded``). ``calc`` defaults
    to a ``MetricsCalculator`` on the card."""
    if calc is None:
        from pnpinversion_tpu_torch.evaluation.calculator import MetricsCalculator

        calc = MetricsCalculator()
    with open(result_path, "w", newline="") as f:
        head = [f"{key}|{m}" for key in tgt_image_folders for m in metrics]
        csv.writer(f).writerow(["file_id"] + head)
    with open(annotation_mapping_file) as f:
        annotation = json.load(f)
    if sharded:
        from pnpinversion_tpu_torch.evaluation.sharded import SUPPORTED

        if not all(m in SUPPORTED for m in metrics):
            raise ValueError(f"--sharded supports only device metrics ({SUPPORTED}); drop the "
                             "flag for others")
        _evaluate_sharded(annotation, metrics, src_image_folder, tgt_image_folders, result_path,
                          edit_category_list, calc, batch_size)
        return
    for it in _normalized_items(annotation, edit_category_list):
        mask = it["mask"]
        src_image = Image.open(os.path.join(src_image_folder, it["src_path"]))
        row = [it["file_id"]]
        for folder in tgt_image_folders.values():
            tgt_image = crop_edit_panel(Image.open(os.path.join(folder, it["tgt_path"])))
            for metric in metrics:
                if _nan_sentinel(metric, mask, it["has_mask"], it["src_prompt"]):
                    row.append("nan")
                else:
                    row.append(calculate_metric(calc, metric, src_image, tgt_image, mask, mask,
                                                it["src_prompt"], it["tgt_prompt"]))
        with open(result_path, "a+", newline="") as f:
            csv.writer(f).writerow(row)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--annotation_mapping_file", type=str, default="data/mapping_file.json")
    parser.add_argument("--metrics", nargs="+", type=str, default=DEFAULT_METRICS)
    parser.add_argument("--src_image_folder", type=str, default="data/annotation_images")
    parser.add_argument("--tgt_methods", nargs="+", type=str,
                        default=["1_ddim+p2p", "1_directinversion+p2p"])
    parser.add_argument("--result_path", type=str, default="evaluation_result.csv")
    parser.add_argument("--output_root", type=str, default="output")
    parser.add_argument("--checkpoint_dir", type=str, default=None)
    parser.add_argument("--edit_category_list", nargs="+", type=str,
                        default=[str(i) for i in range(10)])
    parser.add_argument("--evaluate_whole_table", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the metrics run: cuda (raises without CUDA) or cpu")
    parser.add_argument("--sharded", action="store_true",
                        help="batch the metrics over images, split over the host's GPUs")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="--sharded: images a step (default: one per device)")
    args = parser.parse_args(argv)

    registry = all_tgt_image_folders(args.output_root)
    if args.evaluate_whole_table:
        # --tgt_methods holds group ids ("1".."8") in whole-table mode
        folders = {k: v for k, v in registry.items() if k.split("_", 1)[0] in args.tgt_methods}
    else:
        folders = {k: registry[k] for k in args.tgt_methods}

    from pnpinversion_tpu_torch.evaluation.calculator import MetricsCalculator

    calc = MetricsCalculator(checkpoint_dir=args.checkpoint_dir, device=args.device)
    evaluate(args.annotation_mapping_file, args.metrics, args.src_image_folder, folders,
             args.result_path, args.edit_category_list, calc, sharded=args.sharded,
             batch_size=args.batch_size)


if __name__ == "__main__":
    main()
