"""Where the port's entry points run, and the f32 policy on the card.

Entry points run on ``cuda`` unless the caller passes a device; without a
CUDA device they raise rather than fall back to the CPU.

f32 on the card means full f32. PyTorch runs f32 matrix products in full f32
by default, but sends f32 convolutions through cuDNN in TF32
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits. The JAX package's f32 paths and the CPU reference keep all
24 bits, so the entry points that make models on the card (``SDPipeline``,
of any dtype, since a bf16 pipeline computes in f32 for the f32 families;
the ``MetricsCalculator``) call ``use_full_f32``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``; raises when CUDA is absent and the
    CPU was not asked for (never a quiet fall back to the CPU)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
    return dev


def use_full_f32() -> None:
    """Turns TF32 off for f32 matrix products and cuDNN convolutions, for the
    whole process: f32 work on the card then keeps full f32 precision. bf16
    work is unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
