"""Plug-and-Play PIE-Bench runner: the port of ``runners/run_editing_pnp.py``.

    python -m pnpinversion_tpu_torch.runners.run_editing_pnp \\
        --data_path D --output_path O [--edit_method_list ...] [--checkpoint_dir C] \\
        [--device cpu]

The reference runs PnP on SD1.5 weights: pass them with ``--checkpoint_dir``
(the same architecture).
The pipeline is f32, as the JAX runner's (full f32 on the card);
``--checkpoint_dir`` loads local weights (``convert/checkpoint.py``), random
weights without. Output: ``O/<method folder>/annotation_images/<image>``.
"""
from __future__ import annotations

from typing import Optional, Sequence

from pnpinversion_tpu_torch.cli import make_pipeline, run_benchmark, standard_argparser
from pnpinversion_tpu_torch.configs import SD14
from pnpinversion_tpu_torch.editors.pnp_editor import PnPEditor

IMAGE_SAVE_PATHS = {"ddim+pnp": "ddim+pnp", "directinversion+pnp": "directinversion+pnp"}


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = standard_argparser(["directinversion+pnp"])
    args = parser.parse_args(argv)
    editor = PnPEditor(make_pipeline(args, SD14))

    def edit_fn(edit_method, item):
        return editor(edit_method, item.image_path, item.source_prompt, item.target_prompt,
                      guidance_scale=7.5)

    run_benchmark(args, edit_fn, IMAGE_SAVE_PATHS)


if __name__ == "__main__":
    main()
