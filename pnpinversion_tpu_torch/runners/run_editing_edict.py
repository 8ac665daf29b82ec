"""EDICT PIE-Bench runner: the port of ``runners/run_editing_edict.py``.

    python -m pnpinversion_tpu_torch.runners.run_editing_edict \\
        --data_path D --output_path O [--edit_method_list ...] [--checkpoint_dir C] \\
        [--device cpu]

``--precision``: the latent pair's carry, ``df64`` (the reference's float64
algebra; a native float64 pair in the port) or ``f32``.
The pipeline is f32, as the JAX runner's (full f32 on the card);
``--checkpoint_dir`` loads local weights (``convert/checkpoint.py``), random
weights without. Output: ``O/<method folder>/annotation_images/<image>``.
"""
from __future__ import annotations

from typing import Optional, Sequence

from pnpinversion_tpu_torch.cli import make_pipeline, run_benchmark, standard_argparser
from pnpinversion_tpu_torch.configs import SD14
from pnpinversion_tpu_torch.editors.edict_editor import EDICTEditor

IMAGE_SAVE_PATHS = {"edict+direct_forward": "edict+direct_forward", "edict+p2p": "edict+p2p"}


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = standard_argparser(["edict+p2p"])
    parser.add_argument("--precision", choices=["f32", "df64"], default="df64",
                        help="latent-carry precision: df64 is the reference's float64 algebra "
                             "(edict_functions.py:50-52); f32 is faster")
    args = parser.parse_args(argv)
    editor = EDICTEditor(make_pipeline(args, SD14), precision=args.precision)

    def edit_fn(edit_method, item):
        return editor(edit_method, item.image_path, item.source_prompt, item.target_prompt)

    run_benchmark(args, edit_fn, IMAGE_SAVE_PATHS)


if __name__ == "__main__":
    main()
