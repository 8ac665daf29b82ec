"""LPIPS with a SqueezeNet-1.1 backbone (port of
``pnpinversion_tpu/models/lpips.py``): torchmetrics'
LearnedPerceptualImagePatchSimilarity(net_type='squeeze') as the reference
evaluator configures it. Seven ReLU taps, each unit-normalised over channels,
the squared difference weighted by a bias-free 1x1 head, the spatial mean,
summed over taps. Inputs in [-1, 1]. Convolutions only: no kernel of the
port runs here.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from pnpinversion_tpu_torch.models.layers import Conv2d, init_random_

# SqueezeNet-1.1 fires: (in, squeeze, expand1x1, expand3x3)
FIRES = [
    (64, 16, 64, 64),
    (128, 16, 64, 64),
    (128, 32, 128, 128),
    (256, 32, 128, 128),
    (256, 48, 192, 192),
    (384, 48, 192, 192),
    (384, 64, 256, 256),
    (512, 64, 256, 256),
]
# channels at the 7 taps
LPIPS_CHANNELS = [64, 128, 256, 384, 384, 512, 512]
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class Fire(nn.Module):
    def __init__(self, cin: int, squeeze: int, e1: int, e3: int):
        super().__init__()
        self.squeeze = Conv2d(cin, squeeze, 1)
        self.expand1 = Conv2d(squeeze, e1, 1)
        self.expand3 = Conv2d(squeeze, e3, 3)  # "SAME" at stride 1: padding 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1(s)), F.relu(self.expand3(s))], dim=1)


def maxpool_ceil(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(3, 2, ceil_mode=True): the last window may hang over the
    bottom and right edges (the JAX package pads them with -inf)."""
    return F.max_pool2d(x, 3, 2, ceil_mode=True)


def unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """f / (||f|| + eps) over the channels of (B, C, H, W), in f32: eps is
    added to the norm, not under the square root."""
    norm = torch.sqrt(torch.sum(f.float() ** 2, dim=1, keepdim=True))
    return f / (norm + eps)


class LPIPS(nn.Module):
    """SqueezeNet-1.1 taps and the seven linear heads. ``forward(img0,
    img1)`` takes (B, H, W, 3) images in [-1, 1] and returns the LPIPS
    distance summed over the batch, a scalar; ``distances`` each pair's."""

    def __init__(self):
        super().__init__()
        self.conv0 = Conv2d(3, 64, 3, stride=2, padding="VALID")
        self.fires = nn.ModuleList([Fire(*f) for f in FIRES])
        self.lins = nn.ModuleList([nn.Conv2d(c, 1, 1, bias=False) for c in LPIPS_CHANNELS])

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The 7 taps of x (B, 3, H, W), already through the scaling layer."""
        f = self.fires
        h = F.relu(self.conv0(x))
        taps = [h]
        h = f[1](f[0](maxpool_ceil(h)))
        taps.append(h)
        h = f[3](f[2](maxpool_ceil(h)))
        taps.append(h)
        h = f[4](maxpool_ceil(h))
        taps.append(h)
        for fire in f[5:]:
            h = fire(h)
            taps.append(h)
        return taps

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        return self.distances(img0, img1).sum()

    def distances(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """The LPIPS distance of each pair, (B,) f32."""
        shift = torch.tensor(SHIFT, dtype=torch.float32, device=img0.device)
        scale = torch.tensor(SCALE, dtype=torch.float32, device=img0.device)

        def prep(img):
            return ((img.float() - shift) / scale).permute(0, 3, 1, 2)

        total = torch.zeros(img0.shape[0], dtype=torch.float32, device=img0.device)
        for t0, t1, lin in zip(self.features(prep(img0)), self.features(prep(img1)), self.lins):
            d = (unit_normalize(t0) - unit_normalize(t1)) ** 2
            total = total + lin(d.float()).mean(dim=(1, 2, 3))
        return total


def init_lpips_(model: LPIPS, generator: torch.Generator) -> LPIPS:
    """The JAX package's init, drawn from ``generator``: convolutions
    uniform(+-1/sqrt(fan_in)) with zero biases, the heads |N(0, 1)| * 0.1."""
    init_random_(model, generator)
    with torch.no_grad():
        for lin in model.lins:
            lin.weight.normal_(0.0, 1.0, generator=generator).abs_().mul_(0.1)
    return model
