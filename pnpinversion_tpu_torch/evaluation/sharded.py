"""Batched evaluation over one or more devices (port of
``pnpinversion_tpu/evaluation/sharded.py``).

Where the calculator scores one (image, metric) pair at a time, this scores
a batch of images per metric with one forward of each metric model per
device: the batch is padded to a multiple of the device count and split in
contiguous blocks, one a device (the torch form of the JAX package's
``jax.vmap`` over a ``('dp',)`` mesh); each device holds a copy of the
calculator's models. The semantics are the calculator's: the mask applied
to the images before the metric, the DINO structure distance on 0..255
floats, CLIP's text pooled at the first EOS and its score clamped at 0. The
"nan" sentinels of empty or full masks stay with the caller, on the host.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pnpinversion_tpu_torch.evaluation import metrics as M
from pnpinversion_tpu_torch.evaluation.calculator import MetricsCalculator
from pnpinversion_tpu_torch.models import vit
from pnpinversion_tpu_torch.parallel.sweep import pad_batch

#: the metrics the batched path computes; the serial calculator has the rest
SUPPORTED = (
    "psnr", "mse", "ssim", "lpips", "structure_distance",
    "psnr_unedit_part", "mse_unedit_part", "ssim_unedit_part",
    "lpips_unedit_part", "structure_distance_unedit_part",
    "psnr_edit_part", "mse_edit_part", "ssim_edit_part", "lpips_edit_part",
    "structure_distance_edit_part",
    "clip_similarity_source_image", "clip_similarity_target_image",
    "clip_similarity_target_image_edit_part",
)
_MODELS = ("clip_vision", "clip_text", "clip_text_proj", "lpips", "dino")


class ShardedEvaluator:
    """Batched metrics over ``calc``'s models, on ``devices`` (the
    calculator's device by default)."""

    def __init__(self, calc: MetricsCalculator, devices: Optional[Sequence] = None):
        self.calc = calc
        self.devices = [torch.device(d) for d in (devices or [calc.device])]
        self._models = [{name: getattr(calc, name) if d == calc.device
                         else copy.deepcopy(getattr(calc, name)).to(d) for name in _MODELS}
                        for d in self.devices]

    # ------------------------------------------------------------- text side
    @torch.inference_mode()
    def text_features(self, prompts: Sequence[str]) -> torch.Tensor:
        """CLIP text features (N, proj_dim) on the first device, each pooled
        at its first EOS (at the largest id where the tokenizer has no EOS)."""
        calc, models = self.calc, self._models[0]
        ids = calc.tokenizer(list(prompts), max_length=calc.clip_text_cfg.max_length)["input_ids"]
        ids = torch.as_tensor(np.asarray(ids, np.int64), device=self.devices[0])
        h = models["clip_text"](ids)
        eos_id = getattr(calc.tokenizer, "eos_token_id", None)
        pos = torch.argmax(ids if eos_id is None else (ids == eos_id).int(), dim=1)
        return models["clip_text_proj"](h[torch.arange(len(ids), device=ids.device), pos])

    # ------------------------------------------------------------ image side
    def _block(self, models: dict, metrics: Sequence[str], src01: torch.Tensor,
               tgt01: torch.Tensor, mask: torch.Tensor, src_txt: torch.Tensor,
               tgt_txt: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Every metric of one device's block: images (n, H, W, 3) in [0, 1],
        masks (n, H, W, 3) in {0, 1}, text features (n, proj_dim)."""
        calc = self.calc

        def clip_sim(img01, txt):
            x = M.clip_normalize(M.center_crop_resize_224(img01, calc.clip_vision_cfg.image_size))
            emb, _ = models["clip_vision"](x)
            cos = torch.sum(emb * txt, dim=1) / (torch.linalg.norm(emb, dim=1)
                                                 * torch.linalg.norm(txt, dim=1))
            return torch.clamp(100.0 * cos, min=0.0)

        def pair_metric(name, a01, b01):
            if name == "psnr":
                return 10.0 * torch.log10(1.0 / torch.mean((a01 - b01) ** 2, dim=(1, 2, 3)))
            if name == "mse":
                return torch.mean((a01 - b01) ** 2, dim=(1, 2, 3))
            if name == "ssim":
                return torch.mean(M.ssim_map(a01, b01), dim=(1, 2, 3))
            if name == "lpips":
                return models["lpips"].distances(a01 * 2 - 1, b01 * 2 - 1)
            if name == "structure_distance":
                # the reference's quirk: 0..255 floats through the ImageNet normaliser
                size = calc.dino_cfg.image_size
                a, b = (M.imagenet_normalize(M.resize(x * 255.0, (size, size), "bilinear"))
                        for x in (a01, b01))
                return vit.structure_distances(models["dino"], a, b,
                                               layer=calc.dino_cfg.layers - 1)
            raise ValueError(name)

        out = {}
        for m in metrics:
            if m == "clip_similarity_source_image":
                out[m] = clip_sim(src01, src_txt)
            elif m == "clip_similarity_target_image":
                out[m] = clip_sim(tgt01, tgt_txt)
            elif m == "clip_similarity_target_image_edit_part":
                out[m] = clip_sim(tgt01 * mask, tgt_txt)
            elif m.endswith("_unedit_part"):
                out[m] = pair_metric(m[: -len("_unedit_part")], src01 * (1 - mask),
                                     tgt01 * (1 - mask))
            elif m.endswith("_edit_part"):
                out[m] = pair_metric(m[: -len("_edit_part")], src01 * mask, tgt01 * mask)
            else:
                out[m] = pair_metric(m, src01, tgt01)
        return out

    @torch.inference_mode()
    def evaluate_batch(self, metrics: Sequence[str], src_imgs_u8: np.ndarray,
                       tgt_imgs_u8: np.ndarray, masks: np.ndarray,
                       src_prompts: Sequence[str], tgt_prompts: Sequence[str],
                       ) -> Dict[str, np.ndarray]:
        """All arrays have a leading N; masks (N, H, W, 3) in {0, 1}. Returns
        {metric: (N,) f32}; the batch is padded to a multiple of the device
        count internally. The "nan" sentinels are the caller's."""
        for m in metrics:
            if m not in SUPPORTED:
                raise ValueError(f"unsupported batched metric {m!r}")
        n, k = len(src_imgs_u8), len(self.devices)
        src_b, _ = pad_batch(list(np.asarray(src_imgs_u8)), k)
        tgt_b, _ = pad_batch(list(np.asarray(tgt_imgs_u8)), k)
        mask_b, _ = pad_batch(list(np.asarray(masks).astype(np.float32)), k)
        feats = self.text_features(list(src_prompts) + list(tgt_prompts))
        src_t, _ = pad_batch(list(feats[:n].cpu().numpy()), k)
        tgt_t, _ = pad_batch(list(feats[n:].cpu().numpy()), k)
        per = len(src_b) // k
        parts: List[Dict[str, torch.Tensor]] = []
        for i, (device, models) in enumerate(zip(self.devices, self._models)):
            sl = slice(i * per, (i + 1) * per)

            def put(a, _sl=sl, _d=device):
                return torch.as_tensor(np.ascontiguousarray(a[_sl]), device=_d)

            parts.append(self._block(models, metrics, put(src_b).float() / 255.0,
                                     put(tgt_b).float() / 255.0, put(mask_b), put(src_t),
                                     put(tgt_t)))
        return {m: np.concatenate([p[m].float().cpu().numpy() for p in parts])[:n]
                for m in metrics}
