"""StableDiffusion pipeline bundle (port of ``pnpinversion_tpu/pipeline.py``):
the UNet, VAE and text encoder modules, tokenizer, DDIM schedule, device and
dtype.

``SDPipeline.create`` runs on ``cuda`` unless the caller passes a device; with
no CUDA device and no device given it raises. The dtype defaults to bf16 on
the card and f32 on the CPU, and every float parameter is cast to it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from pnpinversion_tpu_torch.configs import SD14, StableDiffusionConfig
from pnpinversion_tpu_torch.convert import from_jax_params
from pnpinversion_tpu_torch.models.clip_text import CLIPTextModel
from pnpinversion_tpu_torch.models.layers import init_random_
from pnpinversion_tpu_torch.models.unet import UNet, lb_resolution, num_lb_slots
from pnpinversion_tpu_torch.models.vae import VAE
from pnpinversion_tpu_torch.schedulers.ddim import DDIMSchedule, make_ddim_schedule
from pnpinversion_tpu_torch.utils.tokenizer import default_tokenizer


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``; raises when CUDA is absent and no
    device was asked for (never a quiet fall back to the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
    return torch.device("cuda")


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
    ) -> "SDPipeline":
        """Random-weight pipeline (the JAX package's init distributions, drawn
        from ``seed`` on the device), or the weights of a JAX param tree with
        numpy leaves when ``jax_params`` is given."""
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        if jax_params is not None:
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
        return cls(config=config, unet=modules["unet"], vae=modules["vae"],
                   text_encoder=modules["text"], tokenizer=tokenizer or default_tokenizer(),
                   schedule=make_ddim_schedule(num_steps=num_ddim_steps), device=device,
                   dtype=dtype)

    def tokenize(self, prompts: Sequence[str]) -> torch.Tensor:
        ids = self.tokenizer(list(prompts), padding="max_length",
                             max_length=self.config.text.max_length, truncation=True)["input_ids"]
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

