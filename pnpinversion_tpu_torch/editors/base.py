"""What the port's single-image editors share: the input image, its VAE codec
and the 4-panel result strip [instruction | ground truth |
reconstruction | edit], uint8 (H, 4W, 3)."""
from __future__ import annotations

import numpy as np
import torch

from pnpinversion_tpu_torch.models.vae import image_to_latent, latent_to_image, to_host
from pnpinversion_tpu_torch.pipeline import SDPipeline
from pnpinversion_tpu_torch.utils.image import load_image, make_strip, txt_draw
from pnpinversion_tpu_torch.utils.observability import host_sync


class Editor:
    def __init__(self, pipeline: SDPipeline):
        self.pipe = pipeline

    def load(self, image_path) -> np.ndarray:
        """The ground-truth image: a path or an array, uint8 (H, W, 3) at the
        pipeline's image size."""
        return load_image(image_path, self.pipe.config.image_size)

    def encode_image(self, image: np.ndarray, dtype=None) -> torch.Tensor:
        """uint8 (H, W, 3) -> scaled latent (1, h, w, 4), encoded in ``dtype``
        (the pipeline's by default)."""
        host_sync("images", self.pipe.device)
        img = torch.as_tensor(np.ascontiguousarray(image), device=self.pipe.device)
        return image_to_latent(self.pipe.vae, img, dtype=dtype or self.pipe.dtype)

    def decode_image(self, latents: torch.Tensor) -> np.ndarray:
        """(B, h, w, 4) -> uint8 (B, H, W, 3) on the host, decoded in the
        latents' dtype (f32 for EF's, EDICT's and the instruction editors'
        latents, whatever the pipeline's)."""
        return to_host(latent_to_image(self.pipe.vae, latents))

    def strip(self, prompt_src, prompt_tar, image_gt, recon, edit) -> np.ndarray:
        size = self.pipe.config.image_size
        instruct = txt_draw(f"source prompt: {prompt_src}\ntarget prompt: {prompt_tar}",
                            target_size=(size, size))
        return make_strip([instruct, image_gt, recon, edit])
