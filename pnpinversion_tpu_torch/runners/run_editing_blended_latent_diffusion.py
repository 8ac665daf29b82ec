"""Blended Latent Diffusion PIE-Bench runner: the port of
``runners/run_editing_blended_latent_diffusion.py``.

    python -m pnpinversion_tpu_torch.runners.run_editing_blended_latent_diffusion \\
        --data_path D --output_path O [--edit_method_list ...] [--checkpoint_dir C] \\
        [--device cpu]

SD2.1-base (``configs.SD21``) and the PIE ground-truth masks, guidance 7.5,
blending 0.25.
The pipeline is f32, as the JAX runner's (full f32 on the card);
``--checkpoint_dir`` loads local weights (``convert/checkpoint.py``), random
weights without. Output: ``O/<method folder>/annotation_images/<image>``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from PIL import Image

from pnpinversion_tpu_torch.cli import make_pipeline, run_benchmark, standard_argparser
from pnpinversion_tpu_torch.configs import SD21
from pnpinversion_tpu_torch.editors.bld_editor import BlendedLatentDiffusionEditor

IMAGE_SAVE_PATHS = {"blended-latent-diffusion": "blended-latent-diffusion"}


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = standard_argparser(["blended-latent-diffusion"])
    args = parser.parse_args(argv)
    editor = BlendedLatentDiffusionEditor(make_pipeline(args, SD21))

    def edit_fn(edit_method, item):
        mask = Image.fromarray(np.uint8(item.mask)).convert("L")
        return editor(edit_method, item.image_path, mask, item.target_prompt,
                      guidance_scale=7.5, blending_percentage=0.25)

    run_benchmark(args, edit_fn, IMAGE_SAVE_PATHS)


if __name__ == "__main__":
    main()
