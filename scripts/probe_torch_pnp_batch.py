"""Why the PnP sweep's edit of an image moves with the other images of its
batch on the card (ROADMAP C17): SD1.4 on seeded random weights (bf16, 512^2,
the word tokenizer a pipeline without a checkpoint threads), one image alone
against the same image beside a second, each batch in the sweep's order (the
chunk's prompts embedded, then the batched class's constant prompts) with a
fresh tokenizer, at 1 and 2 DDIM steps, for ``directinversion+pnp`` and, as
the others' measure, ``directinversion+masactrl``; and PnP again with the
negative prompt's words numbered first, so that its ids no longer depend on
the other item's words. Prints the mean and max uint8 |difference| of the
image's reconstruction and edit panels (no JPEG), batch 1 against batch 2.

    python3 scripts/probe_torch_pnp_batch.py

Needs one CUDA device (the port's kernels build on first use).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_pnp_batch: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import CAKE_PROMPTS, _diff, _random_images
    from pnpinversion_tpu_torch.configs import SD14
    from pnpinversion_tpu_torch.editors.pnp_editor import NEGATIVE_PROMPT
    from pnpinversion_tpu_torch.parallel.sweep import BatchedMasaCtrl, BatchedPnP
    from pnpinversion_tpu_torch.pipeline import SDPipeline
    from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule
    from pnpinversion_tpu_torch.utils.tokenizer import default_tokenizer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    pipe = SDPipeline.create(SD14, seed=0)
    image = _random_images(8080, pipe.config.image_size)
    imgs = np.stack([image(), image()])

    def edit(method: str, n: int, numbered_first: bool):
        pipe.tokenizer = default_tokenizer()
        if numbered_first:
            pipe.tokenizer.encode(NEGATIVE_PROMPT)
        pairs = CAKE_PROMPTS[:n]
        with torch.inference_mode():
            if method == "directinversion+pnp":
                both = pipe.encode_prompt([t for pair in pairs for t in pair]).view(n, 2, 77, -1)
                return BatchedPnP(pipe).edit_batch(method, imgs[:n], both[:, :1], both[:, 1:],
                                                   7.5)
            cond = pipe.encode_prompt([t for _, tar in pairs for t in ("", tar)]).view(
                n, 2, 77, -1)
            return BatchedMasaCtrl(pipe).edit_batch(True, imgs[:n], cond, 7.5)

    out = {}
    for steps in (1, 2):
        pipe.schedule = make_ddim_schedule(steps)
        for method, numbered_first in (("directinversion+pnp", False),
                                       ("directinversion+pnp", True),
                                       ("directinversion+masactrl", False)):
            one, two = edit(method, 1, numbered_first), edit(method, 2, numbered_first)
            label = f"{method}{', negative prompt numbered first' if numbered_first else ''}"
            out.setdefault(label, {})[steps] = {
                panel: dict(zip(("max", "mean"), _diff(b[0], a[0])))
                for panel, a, b in zip(("recon", "edit"), one, two)}
    print("pnp_batch", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
