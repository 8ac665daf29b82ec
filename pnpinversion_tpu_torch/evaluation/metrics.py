"""Image-quality metrics (port of ``pnpinversion_tpu/evaluation/metrics.py``),
in torch on the device of their inputs, f32 throughout:

- PSNR (data range 1), MSE, SSIM (data range 1, a Gaussian 11x11 window of
  sigma 1.5, no padding): the reference's torchmetrics settings. Masked
  variants multiply the image by the mask before the metric, a quirk the
  evaluator keeps for table parity.
- ``resize``: the JAX package's image resize (``jax.image.resize``), which the
  CLIP preprocessing, the structure distance and the ViT's position-embedding
  interpolation go through. It is not ``F.interpolate``: JAX's bicubic is the
  Keys kernel with a = -0.5 (PyTorch's, -0.75) and, when it shrinks, the
  kernel is widened by the scale (antialiasing), which ``F.interpolate``
  does only on request and in its own way. So each axis gets an (in, out)
  weight matrix computed as JAX computes it, and the image two matrix
  products.

LPIPS, CLIP similarity and the DINO structure distance live in their model
modules; this file has the closed-form metrics and the preprocessing.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_F32_EPS = float(np.finfo(np.float32).eps)


def mse(img_pred: torch.Tensor, img_gt: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all elements (images in [0, 1])."""
    d = img_pred.float() - img_gt.float()
    return torch.mean(d * d)


def psnr(img_pred: torch.Tensor, img_gt: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """PSNR, torchmetrics' PeakSignalNoiseRatio with data_range 1."""
    return 10.0 * torch.log10(data_range ** 2 / mse(img_pred, img_gt))


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim_map(img_pred: torch.Tensor, img_gt: torch.Tensor, data_range: float = 1.0,
             kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
             k2: float = 0.03) -> torch.Tensor:
    """The SSIM map (B, C, H - 10, W - 10) as torchmetrics'
    StructuralSimilarityIndexMeasure computes it by default: a depthwise
    Gaussian filter without padding (the borders are cropped). img: (H, W, C)
    or (B, H, W, C) in [0, 1]."""
    if img_pred.dim() == 3:
        img_pred, img_gt = img_pred[None], img_gt[None]
    x = img_pred.float().permute(0, 3, 1, 2)
    y = img_gt.float().permute(0, 3, 1, 2)
    c = x.shape[1]
    kern = _gaussian_kernel(kernel_size, sigma, x.device)[None, None].expand(c, 1, -1, -1)

    def filt(z):
        return F.conv2d(z, kern, groups=c)

    mu_x, mu_y = filt(x), filt(y)
    sigma_x = filt(x * x) - mu_x * mu_x
    sigma_y = filt(y * y) - mu_y * mu_y
    sigma_xy = filt(x * y) - mu_x * mu_y
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    return num / den


def ssim(img_pred: torch.Tensor, img_gt: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """SSIM, the mean of ``ssim_map`` (over the batch too, for (B, H, W, C))."""
    return torch.mean(ssim_map(img_pred, img_gt, data_range, kernel_size, sigma, k1, k2))


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5, as JAX writes it."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


_KERNELS = {"bicubic": _keys_cubic, "bilinear": _triangle}


def _resize_weights(in_size: int, out_size: int, method: str, device=None) -> torch.Tensor:
    """(in_size, out_size) f32 weights of one axis of ``jax.image.resize``
    (antialias on): half-pixel centres, the kernel widened by 1/scale when
    shrinking, each output's weights normalised to sum 1 (0 where they sum to
    about 0), outputs whose sample lies outside the input zeroed."""
    if method not in _KERNELS:
        raise ValueError(f"resize method must be one of {sorted(_KERNELS)}, got {method!r}")
    f32 = torch.float32
    # JAX takes 1/scale in Python floats and rounds it to f32 where it meets
    # the f32 coordinates
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=f32, device=device)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None])
    weights = _KERNELS[method](x / kernel_scale)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * _F32_EPS,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize(img: torch.Tensor, size: Sequence[int], method: str = "bicubic") -> torch.Tensor:
    """``jax.image.resize`` of the two spatial dims of (..., H, W, C) to
    ``size`` (h, w), in f32. A dim whose size does not change is left as it
    is, as JAX leaves it."""
    x = img.float()
    h, w = x.shape[-3], x.shape[-2]
    if h != size[0]:
        wh = _resize_weights(h, size[0], method, x.device)
        x = torch.einsum("...hwc,ho->...owc", x, wh)
    if w != size[1]:
        ww = _resize_weights(w, size[1], method, x.device)
        x = torch.einsum("...hwc,wo->...hoc", x, ww)
    return x


def center_crop_resize_224(img: torch.Tensor, size: int = 224,
                           method: str = "bicubic") -> torch.Tensor:
    """CLIP preprocessing: resize the shortest side to ``size``, then crop the
    centre. img: (..., H, W, C) float. The long side truncates (``int()``),
    as transformers' ``get_resize_output_image_size`` does for torchmetrics'
    CLIPScore: a ``round()`` would move the crop by a pixel."""
    h, w = img.shape[-3], img.shape[-2]
    if h <= w:
        nh, nw = size, max(size, int(w * size / h))
    else:
        nh, nw = max(size, int(h * size / w)), size
    img = resize(img, (nh, nw), method)
    top, left = (nh - size) // 2, (nw - size) // 2
    return img[..., top : top + size, left : left + size, :]


def _normalize(img: torch.Tensor, mean, std) -> torch.Tensor:
    m = torch.tensor(mean, dtype=torch.float32, device=img.device)
    s = torch.tensor(std, dtype=torch.float32, device=img.device)
    return (img - m) / s


def clip_normalize(img01: torch.Tensor) -> torch.Tensor:
    return _normalize(img01, CLIP_MEAN, CLIP_STD)


def imagenet_normalize(img: torch.Tensor) -> torch.Tensor:
    """The reference feeds 0..255 floats into this transform for the structure
    distance; the port keeps that, and callers choose the input scale."""
    return _normalize(img, IMAGENET_MEAN, IMAGENET_STD)
