"""One P2P edit of one image: the port of ``runners/run_editing_p2p_one_image.py``.

    python -m pnpinversion_tpu_torch.runners.run_editing_p2p_one_image \\
        --image_path I --prompt_src S --prompt_tar T [--output_path edited.png] \\
        [--blended_word SRC TAR] [--tiny] [--device cpu]

``--tiny`` runs the miniature random-weight config (a smoke test). The
pipeline is f32, as the JAX runner's.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from pnpinversion_tpu_torch.cli import make_pipeline, save_strip
from pnpinversion_tpu_torch.configs import SD14, TINY
from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--image_path", type=str, required=True)
    parser.add_argument("--prompt_src", type=str, required=True)
    parser.add_argument("--prompt_tar", type=str, required=True)
    parser.add_argument("--output_path", type=str, default="edited.png")
    parser.add_argument("--edit_method", type=str, default="directinversion+p2p")
    parser.add_argument("--blended_word", nargs="+", type=str, default=[])
    parser.add_argument("--checkpoint_dir", type=str, default=None)
    parser.add_argument("--num_ddim_steps", type=int, default=50)
    parser.add_argument("--tiny", action="store_true",
                        help="tiny random-weight config (smoke test)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default; raises without CUDA) or cpu")
    args = parser.parse_args(argv)
    editor = P2PEditor(make_pipeline(args, TINY if args.tiny else SD14))
    blended = args.blended_word
    strip = editor(
        args.edit_method, image_path=args.image_path, prompt_src=args.prompt_src,
        prompt_tar=args.prompt_tar, guidance_scale=7.5, cross_replace_steps=0.4,
        self_replace_steps=0.6,
        blend_word=(((blended[0],), (blended[1],)) if len(blended) else None),
        eq_params=({"words": (blended[1],), "values": (2,)} if len(blended) else None))
    save_strip(strip, args.output_path)
    print(f"saved {args.output_path}")


if __name__ == "__main__":
    main()
