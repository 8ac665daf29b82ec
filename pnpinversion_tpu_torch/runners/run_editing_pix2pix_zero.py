"""pix2pix-zero PIE-Bench runner: the port of ``runners/run_editing_pix2pix_zero.py``.

    python -m pnpinversion_tpu_torch.runners.run_editing_pix2pix_zero \\
        --data_path D --output_path O [--caption_file F] [--checkpoint_dir C] \\
        [--device cpu]

Each image's caption comes from ``--caption_file`` (JSON {image key:
caption}) or from the BLIP captioner of ``--checkpoint_dir`` (``blip/`` and
``blip_tokenizer/vocab.txt``: ``models.blip.make_blip_captioner``). As in
the JAX runner, missing BLIP files leave the runner without a captioner
(logged), and an image without a caption then fails. The pipeline is f32,
as the JAX runner's (full f32 on the card). Output:
``O/<method folder>/annotation_images/<image>``.
"""
from __future__ import annotations

import json
from typing import Optional, Sequence

from pnpinversion_tpu_torch.cli import make_pipeline, run_benchmark, standard_argparser
from pnpinversion_tpu_torch.configs import SD14
from pnpinversion_tpu_torch.editors.pix2pix_zero_editor import Pix2PixZeroEditor

IMAGE_SAVE_PATHS = {"ddim+pix2pix-zero": "ddim+pix2pix-zero",
                    "directinversion+pix2pix-zero": "directinversion+pix2pix-zero"}


def load_captioner(checkpoint_dir: Optional[str], device):
    """BLIP from the checkpoint directory, or None (logged) when it has no
    BLIP files, as the JAX runner falls back."""
    if checkpoint_dir is None:
        return None
    from pnpinversion_tpu_torch.models.blip import make_blip_captioner

    try:
        return make_blip_captioner(checkpoint_dir, device=device)
    except FileNotFoundError as exc:
        print(f"no BLIP captioner ({exc}): captions must come from --caption_file", flush=True)
        return None


def load_captions(caption_file: Optional[str]) -> dict:
    if not caption_file:
        return {}
    with open(caption_file) as f:
        return json.load(f)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = standard_argparser(["directinversion+pix2pix-zero"])
    parser.add_argument("--caption_file", type=str, default=None,
                        help="JSON {image key: caption} to use instead of BLIP")
    args = parser.parse_args(argv)
    pipe = make_pipeline(args, SD14)
    editor = Pix2PixZeroEditor(pipe, captioner=load_captioner(args.checkpoint_dir, pipe.device))
    captions = load_captions(args.caption_file)

    def edit_fn(edit_method, item):
        return editor(edit_method, item.image_path, item.source_prompt, item.target_prompt,
                      guidance_scale=7.5, caption=captions.get(item.key))

    run_benchmark(args, edit_fn, IMAGE_SAVE_PATHS)


if __name__ == "__main__":
    main()
