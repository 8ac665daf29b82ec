"""InstructPix2Pix PIE-Bench runner: the port of ``runners/run_editing_instructpix2pix.py``.

    python -m pnpinversion_tpu_torch.runners.run_editing_instructpix2pix \\
        --data_path D --output_path O [--edit_method_list ...] [--checkpoint_dir C] \\
        [--device cpu]

The editing instruction of each item, on the 8-channel UNet (``configs.IP2P``;
weights from a CompVis ``.ckpt`` with ``--checkpoint_dir``), text guidance
7.5, image guidance 1.5.
The pipeline is f32, as the JAX runner's (full f32 on the card);
``--checkpoint_dir`` loads local weights (``convert/checkpoint.py``), random
weights without. Output: ``O/<method folder>/annotation_images/<image>``.
"""
from __future__ import annotations

from typing import Optional, Sequence

from pnpinversion_tpu_torch.cli import make_pipeline, run_benchmark, standard_argparser
from pnpinversion_tpu_torch.configs import IP2P
from pnpinversion_tpu_torch.editors.instruct_editor import InstructEditor

IMAGE_SAVE_PATHS = {"instruct-pix2pix": "instruct-pix2pix"}


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = standard_argparser(["instruct-pix2pix"])
    args = parser.parse_args(argv)
    editor = InstructEditor(make_pipeline(args, IP2P))

    def edit_fn(edit_method, item):
        return editor(edit_method, item.image_path, item.editing_instruction,
                      steps=args.num_ddim_steps, cfg_text=7.5, cfg_image=1.5)

    run_benchmark(args, edit_fn, IMAGE_SAVE_PATHS)


if __name__ == "__main__":
    main()
