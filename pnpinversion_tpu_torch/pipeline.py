"""StableDiffusion pipeline bundle (port of ``pnpinversion_tpu/pipeline.py``):
the UNet, VAE and text encoder modules, tokenizer, DDIM schedule, device and
dtype.

``SDPipeline.create`` runs on ``cuda`` unless the caller passes a device; with
no CUDA device and no device given it raises. The dtype defaults to bf16 on
the card and f32 on the CPU, and every float parameter is cast to it.

The modules compute in their input's dtype (``models/layers.py``: Linear and
Conv2d cast their weights to it), as the JAX package's layers do. So a bf16
pipeline also serves the families that compute in f32 (edit-friendly DDPM's
and EDICT's f32 latents, the instruction editors' f32 sigmas): f32 inputs
run its UNet and VAE in f32 on the bf16-valued weights, with no copy of the
modules. f32 on the card is full f32: ``create`` turns TF32 off for f32
matrix products and cuDNN convolutions (``utils.device.use_full_f32``, for
the process) on every pipeline it makes there, as the JAX package's f32
paths and the CPU reference compute; bf16 work is unaffected.

``quantize="w8"`` (or ``PNPI_QUANT=w8`` when ``quantize`` is None, as in the
JAX package) stores the UNet's matmul weights int8 (``ops/quant.py``),
after the weights are loaded and cast. ``tp_group`` is set by
``parallel.tensor_parallel.shard_pipeline_`` on a pipeline whose modules it
split over a tensor-parallel group.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from pnpinversion_tpu_torch.configs import SD14, StableDiffusionConfig
from pnpinversion_tpu_torch.convert import from_jax_params
from pnpinversion_tpu_torch.models.clip_text import CLIPTextModel
from pnpinversion_tpu_torch.models.layers import init_random_
from pnpinversion_tpu_torch.models.unet import UNet, lb_resolution, num_lb_slots
from pnpinversion_tpu_torch.models.vae import VAE
from pnpinversion_tpu_torch.ops.quant import is_quantized, quantize_unet_dots
from pnpinversion_tpu_torch.schedulers.ddim import DDIMSchedule, make_ddim_schedule
from pnpinversion_tpu_torch.utils.device import resolve_device, use_full_f32
from pnpinversion_tpu_torch.utils.observability import host_sync
from pnpinversion_tpu_torch.utils.tokenizer import default_tokenizer


def default_dtype(device: torch.device) -> torch.dtype:
    return torch.float32 if device.type == "cpu" else torch.bfloat16


@dataclasses.dataclass
class SDPipeline:
    config: StableDiffusionConfig
    unet: UNet
    vae: VAE
    text_encoder: CLIPTextModel
    tokenizer: Any
    schedule: DDIMSchedule
    device: torch.device
    dtype: torch.dtype
    tp_group: Any = None

    @classmethod
    def create(
        cls,
        config: StableDiffusionConfig = SD14,
        seed: int = 0,
        num_ddim_steps: int = 50,
        tokenizer=None,
        device=None,
        dtype: Optional[torch.dtype] = None,
        jax_params: Optional[Dict[str, Any]] = None,
        checkpoint_dir: Optional[str] = None,
        quantize: Optional[str] = None,
    ) -> "SDPipeline":
        """Random-weight pipeline (the JAX package's init distributions, drawn
        from ``seed`` on the device); the weights of a JAX param tree with
        numpy leaves when ``jax_params`` is given; or a local checkpoint's
        when ``checkpoint_dir`` is (an HF pipeline directory or a CompVis
        ``.ckpt``, loaded strictly and cast to ``dtype`` on the device:
        ``convert.checkpoint.load_pipeline_modules``; its ``tokenizer/``
        gives the CLIP BPE tokenizer unless ``tokenizer`` is passed). On
        CUDA it turns TF32 off for the process (full f32, see the module
        docstring). ``quantize``: None (``PNPI_QUANT``), "none" or "w8"; any
        other mode raises ``ValueError``. A JAX w8 tree in ``jax_params``
        loads quantized as it is."""
        quant = quantize or os.environ.get("PNPI_QUANT", "").lower() or None
        if quant not in (None, "none", "w8"):
            raise ValueError(f"unknown quantize mode {quant!r} (only 'w8', or 'none')")
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        if device.type == "cuda":
            use_full_f32()
        if checkpoint_dir is not None:
            from pnpinversion_tpu_torch.convert.checkpoint import load_pipeline_modules

            modules, tokenizer = load_pipeline_modules(checkpoint_dir, config, dtype, device,
                                                       tokenizer)
        elif jax_params is not None:
            modules = from_jax_params(jax_params, config)
        else:
            gen = torch.Generator(device=device).manual_seed(seed)
            with torch.device("meta"):
                modules = {"unet": UNet(config.unet), "vae": VAE(config.vae),
                           "text": CLIPTextModel(config.text)}
            modules = {k: init_random_(m.to_empty(device=device), gen)
                       for k, m in modules.items()}
        for m in modules.values():
            m.to(device=device, dtype=dtype, memory_format=torch.channels_last).eval()
            m.requires_grad_(False)
        if quant == "w8" and not is_quantized(modules["unet"]):
            quantize_unet_dots(modules["unet"])
        return cls(config=config, unet=modules["unet"], vae=modules["vae"],
                   text_encoder=modules["text"], tokenizer=tokenizer or default_tokenizer(),
                   schedule=make_ddim_schedule(num_steps=num_ddim_steps), device=device,
                   dtype=dtype)

    def tokenize(self, prompts: Sequence[str]) -> torch.Tensor:
        ids = self.tokenizer(list(prompts), padding="max_length",
                             max_length=self.config.text.max_length, truncation=True)["input_ids"]
        host_sync("token_ids", self.device)
        return torch.as_tensor(np.asarray(ids, dtype=np.int64), device=self.device)

    @torch.inference_mode()
    def encode_prompt(self, prompts: Sequence[str]) -> torch.Tensor:
        """(B, 77, width) final hidden states in the pipeline dtype."""
        return self.text_encoder(self.tokenize(prompts), dtype=self.dtype)

    @property
    def num_lb_slots(self) -> int:
        return num_lb_slots(self.config.unet)

    @property
    def lb_res(self) -> int:
        return lb_resolution(self.config.unet)

    @property
    def latent_size(self) -> int:
        return self.config.latent_size

