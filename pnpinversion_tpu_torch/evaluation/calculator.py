"""MetricsCalculator (port of ``pnpinversion_tpu/evaluation/calculator.py``):
the evaluator's metrics on one device, in f32. PSNR, MSE and SSIM in closed
form, LPIPS (SqueezeNet), CLIPScore (the ViT-L/14 vision and text towers),
and the DINO ViT-B/8 structure distance.

It runs on ``cuda`` unless the caller passes a device, and on the card in
full f32: TF32 off for matrix products and cuDNN convolutions
(``utils.device.use_full_f32``), as the JAX package and the CPU reference
compute. The towers carry random weights from ``seed`` (the JAX package's
init distributions, drawn by the port's own init) or, for the parity tests,
a JAX calculator's tree (``jax_params``). Real checkpoints come with ROADMAP
A13.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from pnpinversion_tpu_torch.configs import CLIPTextConfig
from pnpinversion_tpu_torch.convert import metric_modules_from_jax_params
from pnpinversion_tpu_torch.evaluation import metrics as M
from pnpinversion_tpu_torch.models import vit
from pnpinversion_tpu_torch.models.clip_text import CLIPTextModel
from pnpinversion_tpu_torch.models.layers import init_random_
from pnpinversion_tpu_torch.models.lpips import LPIPS, init_lpips_
from pnpinversion_tpu_torch.utils.device import resolve_device, use_full_f32
from pnpinversion_tpu_torch.utils.tokenizer import default_tokenizer


def _random_modules(clip_vision: vit.ViTConfig, clip_text: CLIPTextConfig,
                    dino: vit.ViTConfig, proj_dim: int, seed: int,
                    device: torch.device) -> Dict[str, torch.nn.Module]:
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        modules = {"clip_vision": vit.ViT(clip_vision), "clip_text": CLIPTextModel(clip_text),
                   "clip_text_proj": torch.nn.Linear(clip_text.width, proj_dim, bias=False),
                   "lpips": LPIPS(), "dino": vit.ViT(dino)}
    modules = {k: m.to_empty(device=device) for k, m in modules.items()}
    for m in modules.values():
        if isinstance(m, vit.ViT):
            vit.init_vit_(m, gen)
        elif isinstance(m, LPIPS):
            init_lpips_(m, gen)
        else:
            init_random_(m, gen)
    return modules


class MetricsCalculator:
    def __init__(self, seed: int = 0, checkpoint_dir: Optional[str] = None, tokenizer=None,
                 tiny: bool = False, device=None, jax_params: Optional[Dict[str, Any]] = None):
        if checkpoint_dir is not None:
            raise NotImplementedError("MetricsCalculator(checkpoint_dir=...): loading the "
                                      "metric towers' checkpoints is ROADMAP A13, not ported yet")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_full_f32()
        self.tokenizer = tokenizer or default_tokenizer()
        if tiny:
            self.clip_vision_cfg = vit.TINY_VIT
            self.clip_text_cfg = CLIPTextConfig(vocab_size=128, width=32, layers=2, heads=2)
            self.dino_cfg = vit.ViTConfig(image_size=32, patch_size=8, width=24, layers=2,
                                          heads=2, style="dino", activation="gelu")
            self.clip_proj_dim = 16
        else:
            self.clip_vision_cfg = vit.CLIP_VIT_L14
            self.clip_text_cfg = CLIPTextConfig()  # the ViT-L/14 text tower
            self.dino_cfg = vit.DINO_VITB8
            self.clip_proj_dim = 768
        cfgs = (self.clip_vision_cfg, self.clip_text_cfg, self.dino_cfg)
        if jax_params is not None:
            modules = metric_modules_from_jax_params(jax_params, *cfgs)
        else:
            modules = _random_modules(*cfgs, self.clip_proj_dim, seed, self.device)
        for m in modules.values():
            m.to(device=self.device, dtype=torch.float32).eval().requires_grad_(False)
        self.clip_vision, self.clip_text = modules["clip_vision"], modules["clip_text"]
        self.clip_text_proj, self.lpips, self.dino = (modules["clip_text_proj"],
                                                      modules["lpips"], modules["dino"])

    def _tensor(self, img: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(img), device=self.device)

    def _prep(self, img, mask) -> torch.Tensor:
        """The image in [0, 1] f32, times the mask (in f32) where one is given."""
        img = np.array(img).astype(np.float32) / 255.0
        if mask is not None:
            img = img * np.array(mask).astype(np.float32)
        return self._tensor(img)

    # ------------------------------------------------------------- metrics
    @torch.inference_mode()
    def calculate_psnr(self, img_pred, img_gt, mask_pred=None, mask_gt=None) -> float:
        return float(M.psnr(self._prep(img_pred, mask_pred), self._prep(img_gt, mask_gt)))

    @torch.inference_mode()
    def calculate_mse(self, img_pred, img_gt, mask_pred=None, mask_gt=None) -> float:
        return float(M.mse(self._prep(img_pred, mask_pred), self._prep(img_gt, mask_gt)))

    @torch.inference_mode()
    def calculate_ssim(self, img_pred, img_gt, mask_pred=None, mask_gt=None) -> float:
        return float(M.ssim(self._prep(img_pred, mask_pred), self._prep(img_gt, mask_gt)))

    @torch.inference_mode()
    def calculate_lpips(self, img_pred, img_gt, mask_pred=None, mask_gt=None) -> float:
        a = self._prep(img_pred, mask_pred)[None] * 2 - 1
        b = self._prep(img_gt, mask_gt)[None] * 2 - 1
        return float(self.lpips(a, b))

    def _clip_image_features(self, img01: torch.Tensor) -> torch.Tensor:
        x = M.center_crop_resize_224(img01, self.clip_vision_cfg.image_size)
        emb, _ = self.clip_vision(M.clip_normalize(x)[None])
        return emb[0]

    def _clip_text_features(self, txt: str) -> torch.Tensor:
        ids = self.tokenizer([txt], max_length=self.clip_text_cfg.max_length)["input_ids"]
        ids = self._tensor(np.asarray(ids, np.int64))
        h = self.clip_text(ids)
        # CLIP pools at the first EOS. HF takes argmax(ids), which is the first
        # EOS only because the real vocabulary puts EOS at the highest id; the
        # word tokenizer's EOS is 1, so the EOS id is looked up where the
        # tokenizer has one
        eos_id = getattr(self.tokenizer, "eos_token_id", None)
        pos = torch.argmax(ids[0]) if eos_id is None else torch.argmax((ids[0] == eos_id).int())
        return self.clip_text_proj(h[0, pos])

    @torch.inference_mode()
    def clip_cosine(self, img, txt, mask=None) -> float:
        """100 x the cosine of the image's and the text's CLIP embeddings; the
        image times the mask is rounded to uint8 first, as the reference does."""
        img = np.array(img)
        if mask is not None:
            img = np.uint8(img * np.array(mask))
        ie = self._clip_image_features(self._tensor(img.astype(np.float32) / 255.0))
        te = self._clip_text_features(txt)
        return float(100.0 * torch.sum(ie * te) / (torch.linalg.norm(ie) * torch.linalg.norm(te)))

    def calculate_clip_similarity(self, img, txt, mask=None) -> float:
        return max(self.clip_cosine(img, txt, mask), 0.0)

    @torch.inference_mode()
    def calculate_structure_distance(self, img_pred, img_gt, mask_pred=None,
                                     mask_gt=None) -> float:
        # the reference's quirk: 0..255 floats through the ImageNet normaliser
        def prep255(img, mask):
            img = np.array(img).astype(np.float32)
            if mask is not None:
                img = img * np.array(mask).astype(np.float32)
            size = self.dino_cfg.image_size
            x = M.resize(self._tensor(img), (size, size), "bilinear")
            return M.imagenet_normalize(x)[None]

        return float(vit.structure_distance(self.dino, prep255(img_gt, mask_gt),
                                             prep255(img_pred, mask_pred),
                                             layer=self.dino_cfg.layers - 1))
