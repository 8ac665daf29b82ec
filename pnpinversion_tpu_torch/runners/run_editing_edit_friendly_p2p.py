"""Edit-friendly DDPM PIE-Bench runner: the port of ``runners/run_editing_edit_friendly_p2p.py``.

    python -m pnpinversion_tpu_torch.runners.run_editing_edit_friendly_p2p \\
        --data_path D --output_path O [--edit_method_list ...] [--checkpoint_dir C] \\
        [--device cpu]

Source guidance 1, target guidance 7.5, cross replace 0.4, self replace 0.6.
The pipeline is f32, as the JAX runner's (full f32 on the card);
``--checkpoint_dir`` loads local weights (``convert/checkpoint.py``), random
weights without. Output: ``O/<method folder>/annotation_images/<image>``.
"""
from __future__ import annotations

from typing import Optional, Sequence

from pnpinversion_tpu_torch.cli import make_pipeline, run_benchmark, standard_argparser
from pnpinversion_tpu_torch.configs import SD14
from pnpinversion_tpu_torch.editors.ef_editor import EditFriendlyEditor

IMAGE_SAVE_PATHS = {"edit-friendly-inversion+p2p": "edit-friendly-inversion+p2p"}


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = standard_argparser(["edit-friendly-inversion+p2p"])
    args = parser.parse_args(argv)
    editor = EditFriendlyEditor(make_pipeline(args, SD14))

    def edit_fn(edit_method, item):
        return editor(edit_method, item.image_path, item.source_prompt, item.target_prompt,
                      source_guidance_scale=1, target_guidance_scale=7.5,
                      cross_replace_steps=0.4, self_replace_steps=0.6)

    run_benchmark(args, edit_fn, IMAGE_SAVE_PATHS)


if __name__ == "__main__":
    main()
