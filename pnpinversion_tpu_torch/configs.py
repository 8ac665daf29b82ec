"""Static model configurations (the port's own copy of the JAX package's
``configs.py``).

``SD14`` mirrors the architecture of "CompVis/stable-diffusion-v1-4":
UNet2DConditionModel / AutoencoderKL / CLIPTextModel (ViT-L/14 text tower).
``SD21`` is SD2.1-base (Blended Latent Diffusion's model): the same UNet
topology with 64-dim heads and a 1024-wide OpenCLIP text tower. ``IP2P`` is SD1.4 with an 8-channel UNet input (InstructPix2Pix,
InstructDiffusion). ``TINY`` is a shape-compatible miniature for fast CPU
tests.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    sample_size: int = 64  # latent spatial size
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # whether each down block (and the mirrored up block) carries cross-attn
    cross_attention: Tuple[bool, ...] = (True, True, True, False)
    num_heads: int = 8
    # SD2.x uses fixed 64-dim heads (heads = channels//head_dim per level);
    # SD1.x uses a fixed head COUNT (num_heads) with varying head dims
    head_dim: int = 0  # 0 => use num_heads
    context_dim: int = 768
    norm_groups: int = 32
    time_embed_mult: int = 4
    flip_sin_to_cos: bool = True
    freq_shift: int = 0

    def heads_at(self, channels: int) -> int:
        return channels // self.head_dim if self.head_dim else self.num_heads

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * self.time_embed_mult


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    sample_size: int = 512
    scaling_factor: float = 0.18215


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    max_length: int = 77
    # SD1.x CLIP uses quick_gelu; SD2.x (OpenCLIP) uses gelu
    activation: str = "quick_gelu"


@dataclasses.dataclass(frozen=True)
class StableDiffusionConfig:
    unet: UNetConfig
    vae: VAEConfig
    text: CLIPTextConfig
    name: str = "sd"

    @property
    def latent_size(self) -> int:
        return self.unet.sample_size

    @property
    def image_size(self) -> int:
        return self.vae.sample_size


SD14_UNET = UNetConfig()
SD14_VAE = VAEConfig()
SD14_TEXT = CLIPTextConfig()
SD14 = StableDiffusionConfig(unet=SD14_UNET, vae=SD14_VAE, text=SD14_TEXT, name="sd14")

# SD2.1-base: the same UNet topology with 64-dim heads per level (5, 10, 20,
# 20 heads) and the 1024-dim OpenCLIP context
SD21_UNET = UNetConfig(
    block_out_channels=(320, 640, 1280, 1280),
    head_dim=64,
    context_dim=1024,
)
SD21_TEXT = CLIPTextConfig(vocab_size=49408, width=1024, layers=23, heads=16, activation="gelu")
SD21 = StableDiffusionConfig(unet=SD21_UNET, vae=SD14_VAE, text=SD21_TEXT, name="sd21")

# InstructPix2Pix-style edit-conditioned UNet: 8 input channels (4 latent + 4
# image-conditioning channels, concatenated)
IP2P_UNET = dataclasses.replace(SD14_UNET, in_channels=8)
IP2P = StableDiffusionConfig(unet=IP2P_UNET, vae=SD14_VAE, text=SD14_TEXT, name="ip2p")

TINY_UNET = UNetConfig(
    sample_size=8,
    block_out_channels=(32, 64),
    layers_per_block=1,
    cross_attention=(True, True),
    num_heads=2,
    context_dim=32,
    norm_groups=8,
)
TINY_VAE = VAEConfig(
    block_out_channels=(16, 32),
    layers_per_block=1,
    norm_groups=4,
    sample_size=16,  # 2 blocks -> one 2x downsample -> 8x8 latents
)
TINY_TEXT = CLIPTextConfig(vocab_size=128, width=32, layers=2, heads=2, max_length=77)
TINY = StableDiffusionConfig(unet=TINY_UNET, vae=TINY_VAE, text=TINY_TEXT, name="tiny")
