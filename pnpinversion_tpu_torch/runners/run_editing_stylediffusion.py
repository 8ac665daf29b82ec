"""StyleDiffusion PIE-Bench runner: the port of ``runners/run_editing_stylediffusion.py``.

    python -m pnpinversion_tpu_torch.runners.run_editing_stylediffusion \\
        --data_path D --output_path O [--edit_method_list ...] [--checkpoint_dir C] \\
        [--device cpu]

100 inner steps, taus v 0.5, c 0.6, s 0.6, u 0. The reference's folder name
typo ``styleidffusion+p2p`` is kept.
The pipeline is f32, as the JAX runner's (full f32 on the card);
``--checkpoint_dir`` loads local weights (``convert/checkpoint.py``), random
weights without. Output: ``O/<method folder>/annotation_images/<image>``.
"""
from __future__ import annotations

from typing import Optional, Sequence

from pnpinversion_tpu_torch.cli import make_pipeline, run_benchmark, standard_argparser
from pnpinversion_tpu_torch.configs import SD14
from pnpinversion_tpu_torch.editors.stylediffusion_editor import StyleDiffusionEditor

IMAGE_SAVE_PATHS = {"stylediffusion+p2p": "styleidffusion+p2p"}


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = standard_argparser(["stylediffusion+p2p"])
    args = parser.parse_args(argv)
    editor = StyleDiffusionEditor(make_pipeline(args, SD14))

    def edit_fn(edit_method, item):
        return editor(edit_method, item.image_path, item.source_prompt, item.target_prompt,
                      guidance_scale=7.5, num_inner_steps=100, tau_v=0.5, tau_c=0.6,
                      tau_s=0.6, tau_u=0.0)

    run_benchmark(args, edit_fn, IMAGE_SAVE_PATHS)


if __name__ == "__main__":
    main()
