"""P2P-family PIE-Bench runner: the port of ``runners/run_editing_p2p.py``.

    python -m pnpinversion_tpu_torch.runners.run_editing_p2p \\
        --data_path D --output_path O [--edit_method_list ...] [--checkpoint_dir C] \\
        [--device cpu]

Every P2P method the JAX runner knows, with its folder named after it and
its editor arguments (LocalBlend on the blended words, the target word
reweighted by 2, ProxEdit's l0 at quantile 0.75 with inversion guidance).
The pipeline is f32, as the JAX runner's (full f32 on the card);
``--checkpoint_dir`` loads local weights (``convert/checkpoint.py``), random
weights without. Output: ``O/<method folder>/annotation_images/<image>``.
"""
from __future__ import annotations

from typing import Optional, Sequence

from pnpinversion_tpu_torch.cli import make_pipeline, run_benchmark, standard_argparser
from pnpinversion_tpu_torch.configs import SD14
from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor

P2P_METHODS = (
    ["ddim+p2p", "null-text-inversion+p2p", "null-text-inversion+p2p_a800",
     "null-text-inversion+p2p_3090", "negative-prompt-inversion+p2p",
     "directinversion+p2p"]
    + [f"directinversion+p2p_guidance_{a}_{b}"
       for a in ("0", "1", "25", "5", "75") for b in ("1", "5", "25", "75")]
    + ["null-text-inversion+proximal-guidance",
       "negative-prompt-inversion+proximal-guidance",
       "ablation_null-latent-inversion+p2p",
       "ablation_directinversion_08+p2p", "ablation_directinversion_04+p2p"]
    + [f"ablation_directinversion_interval_{k}+p2p" for k in (2, 5, 10, 24, 49)]
    + ["ablation_null-text-inversion_single_branch+p2p",
       "ablation_directinversion_add-source+p2p",
       "ablation_directinversion_add-target+p2p"]
)
IMAGE_SAVE_PATHS = {m: m for m in P2P_METHODS}


def edit_kwargs(item) -> dict:
    """The JAX runner's editor arguments for one PIE-Bench item."""
    blended = item.blended_word
    return dict(
        prompt_src=item.source_prompt, prompt_tar=item.target_prompt, guidance_scale=7.5,
        cross_replace_steps=0.4, self_replace_steps=0.6,
        blend_word=(((blended[0],), (blended[1],)) if len(blended) else None),
        eq_params=({"words": (blended[1],), "values": (2,)} if len(blended) else None),
        proximal="l0", quantile=0.75, use_inversion_guidance=True, recon_lr=1, recon_t=400)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = standard_argparser(["directinversion+p2p"]).parse_args(argv)
    editor = P2PEditor(make_pipeline(args, SD14))

    def edit_fn(edit_method, item):
        return editor(edit_method, image_path=item.image_path, **edit_kwargs(item))

    run_benchmark(args, edit_fn, IMAGE_SAVE_PATHS)


if __name__ == "__main__":
    main()
