"""Weight-only int8 (w8) UNet weights (port of ``pnpinversion_tpu/ops/quant.py``).

An opt-in mode (``SDPipeline.create(quantize="w8")``, ``PNPI_QUANT=w8``, the
runners' ``--quant w8``): the chosen Linear and Conv2d weights of the UNet
are stored int8 with one f32 scale per output channel, ``max|w|`` over the
input axes times the f32 1/127 (what the JAX function's division by 127
becomes under ``jax.jit``, which its ``SDPipeline.create`` applies: XLA
multiplies by the constant's reciprocal, so the eager JAX function's scales
differ from the jitted ones by an ulp in some channels), and ``w / scale``
rounded half to even and clipped to +-127. The layers
compute what the JAX ``qlinear`` and the kxk branch of ``layers.conv2d``
compute, in their order: the product with the int8 weight cast to the
activation's dtype, then times the scale cast to it, then plus the bias.
The scale is not folded into the weight, which in bf16 would round
differently. 1x1 convs keep the linear layout (out, in) and run as
per-pixel matmuls, as in the JAX package.

``quantize_unet_dots`` picks the JAX function's set: every transformer-block
projection and feed-forward linear, ``proj_in``/``proj_out`` where they are
convs, every ``conv_shortcut``, and with ``convs=True`` also ``conv1``,
``conv2``, ``conv_in``, ``conv_out`` and the up/downsamplers' convs. Norms
and the time embedding stay float.

The products are PyTorch's (cuBLAS, cuDNN) over the cast weight: the JAX
package leaves them to XLA outside any Pallas kernel, so there is no kernel
of its own here. Gradients with respect to the inputs flow (the int8
weights are constants), so null-text and the other optimising paths run on
a w8 UNet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pnpinversion_tpu_torch.models.layers import conv2d

_EPS = 1e-8
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()  # 1/127 rounded to f32


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 weight, f32 scale) of a weight whose axis 0 is the output axis:
    one scale per output channel, max |w| over the other axes times the f32
    1/127 (the module docstring)."""
    w = w.detach().float()
    dims = tuple(range(1, w.dim()))
    scale = torch.clamp(w.abs().amax(dim=dims), min=_EPS) * _INV_127
    q = torch.clamp(torch.round(w / scale.view((-1,) + (1,) * len(dims))), -127, 127)
    return q.to(torch.int8), scale


def qlinear(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ int8 weight (out, in), cast to x's dtype; then times the scale,
    then plus the bias, each cast to x's dtype."""
    y = F.linear(x, weight.to(x.dtype)) * scale.to(x.dtype)
    return y if bias is None else y + bias.to(x.dtype)


def qconv2d(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
            bias: Optional[torch.Tensor] = None, stride: int = 1,
            padding: str = "SAME") -> torch.Tensor:
    """The kxk conv of x (B, C, H, W) with the int8 OIHW weight cast to x's
    dtype; then times the per-channel scale, then plus the bias."""
    y = conv2d(x, weight.to(x.dtype), None, stride, padding) * scale.to(x.dtype)[:, None, None]
    return y if bias is None else y + bias.to(x.dtype)[:, None, None]


class _Int8Layer(nn.Module):
    """An int8 ``weight`` (a buffer: a constant) and its f32 ``weight_scale``,
    with the float layer's ``bias``. The scale stays f32 whatever dtype the
    module is cast to (the JAX tree keeps ``kernel_scale`` f32); only its
    device follows."""

    def __init__(self, weight: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor]):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("weight_scale", scale)
        self.bias = None if bias is None else nn.Parameter(bias.detach(), requires_grad=False)

    def _apply(self, fn, recurse=True):
        scale = self.weight_scale
        out = super()._apply(fn, recurse)
        self.weight_scale = scale.to(self.weight_scale.device)
        return out


class QLinear(_Int8Layer):
    """A w8 Linear: weight int8 (out, in)."""

    @classmethod
    def from_float(cls, layer: nn.Linear) -> "QLinear":
        return cls(*quantize_weight(layer.weight), layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qlinear(x, self.weight, self.weight_scale, self.bias)


class QConv2d(_Int8Layer):
    """A w8 Conv2d: weight int8 OIHW, or (out, in) for a 1x1 conv, which runs
    as a per-pixel matmul over the NHWC view."""

    def __init__(self, weight, scale, bias, stride: int = 1, padding: str = "SAME"):
        super().__init__(weight, scale, bias)
        self.stride, self.pad_mode = stride, padding

    @classmethod
    def from_float(cls, layer) -> "QConv2d":
        w = layer.weight
        if w.shape[2:] == (1, 1):
            if layer.stride[0] != 1:
                raise ValueError("a 1x1 conv goes to the linear layout only at stride 1")
            w = w.reshape(w.shape[:2])
        return cls(*quantize_weight(w), layer.bias, layer.stride[0], layer.pad_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dim() == 2:
            y = qlinear(x.permute(0, 2, 3, 1), self.weight, self.weight_scale, self.bias)
            return y.permute(0, 3, 1, 2)
        return qconv2d(x, self.weight, self.weight_scale, self.bias, self.stride, self.pad_mode)


def _swap(parent: nn.Module, name: str, cls) -> None:
    setattr(parent, name, cls.from_float(getattr(parent, name)))


def quantize_unet_dots(unet: nn.Module, convs: bool = False) -> nn.Module:
    """Swaps the UNet's chosen layers (the module docstring) for their w8
    forms, in place; returns ``unet``. Works on meta modules too (to load a
    JAX w8 tree)."""
    from pnpinversion_tpu_torch.models.layers import Conv2d
    from pnpinversion_tpu_torch.models.unet import Resample, ResnetBlock, Transformer2D

    if is_quantized(unet):
        raise ValueError("the UNet is already quantized")
    for m in list(unet.modules()):
        if isinstance(m, Transformer2D):
            for blk in m.transformer_blocks:
                for parent in [mod for mod in blk.modules()]:
                    for name, child in list(parent.named_children()):
                        if isinstance(child, nn.Linear):
                            _swap(parent, name, QLinear)
            for name in ("proj_in", "proj_out"):
                if isinstance(getattr(m, name), Conv2d):
                    _swap(m, name, QConv2d)
        elif isinstance(m, ResnetBlock):
            for name in ("conv_shortcut",) + (("conv1", "conv2") if convs else ()):
                if hasattr(m, name):
                    _swap(m, name, QConv2d)
        elif convs and isinstance(m, Resample):
            _swap(m, "conv", QConv2d)
    if convs:
        _swap(unet, "conv_in", QConv2d)
        _swap(unet, "conv_out", QConv2d)
    return unet


def is_quantized(module: nn.Module) -> bool:
    return any(isinstance(m, _Int8Layer) for m in module.modules())
