"""Whether the images of a batch meet in the numerics of the PyTorch port's
batched editor, on one GPU (SD1.4, random weights from seed 0, bf16, the
cake edit of ``chip_smoke.py`` with a prompt pair of its own per image).

1. One UNet call of the DirectInversion scan (3 rows per image, P2P control
   at step 5, inside the self-replace window and past LocalBlend's start),
   images [a, b, c, d] against [e, b, f, d] (b and d kept in place, the
   others replaced) and against [d, c, b, a] (every image moved): each
   image's eps, max |difference| from its own in the first call; for each
   order, the first module (in the order the UNet runs them) whose output
   differs for an image. The moved order again with
   ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
   off.
2. The batched edit (``edit_batch``, ``--steps`` DDIM steps): [a, b, c, d]
   twice, against [e, b, f, d], [a, g, c, h] and [d, c, b, a]: the max
   uint8 difference of each image's panels from its own in the first run.

    python3 scripts/probe_torch_batch_independence.py [--steps 50]

Needs one CUDA device; builds the port's kernels first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N = 4
# orders of the images (indices into the images and CAKE_PROMPTS_BY_IMAGE):
# 0-3 the first batch, 4-7 the replacements
ORDERS = {"kept_1_3": [4, 1, 5, 3], "kept_0_2": [0, 6, 2, 7], "moved": [3, 2, 1, 0]}


def _module_outputs(unet, n: int, store: dict, against=None, order=None):
    """Forward hooks on every module of the UNet: with ``against`` None,
    keep each module's output (rows image-major, n images); else record, per
    image, the first module whose output differs from ``against`` (the first
    call's outputs, the images in ``order``). Returns the hook handles."""
    names = {m: name for name, m in unet.named_modules()}

    def hook(module, _inputs, out):
        if not torch.is_tensor(out) or out.shape[0] < n or out.shape[0] % n:
            return
        name = names[module]
        if against is None:
            store[name] = out.detach().clone()
            return
        ref = against[name].view((n, -1) + out.shape[1:])
        got = out.detach().view((n, -1) + out.shape[1:])
        for j, img in enumerate(order):
            if img < n and j not in store and not torch.equal(got[j], ref[img]):
                store[j] = {"image": img, "module": name,
                            "max_abs": (got[j].float() - ref[img].float()).abs().max().item()}

    return [m.register_forward_hook(hook) for m in unet.modules()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_batch_independence: no CUDA device", file=sys.stderr)
        return 1
    import dataclasses

    from chip_smoke import CAKE_PROMPTS, _cake_batch, _diff, _random_images
    from pnpinversion_tpu_torch.configs import SD14
    from pnpinversion_tpu_torch.control.p2p import P2PControl
    from pnpinversion_tpu_torch.models.unet import apply_images
    from pnpinversion_tpu_torch.parallel.sweep import BatchedDirectInversionP2P
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe = SDPipeline.create(SD14, seed=0, num_ddim_steps=args.steps)
    # image i's prompt pair: its own for 0-3, the fifth pair for 4-7
    prompts = [CAKE_PROMPTS[min(i, N)] for i in range(2 * N)]

    # 1. one UNet call
    gen = torch.Generator(device="cuda").manual_seed(0)
    size = pipe.latent_size
    x = torch.randn((2 * N, 3, size, size, 4), generator=gen, device="cuda").to(pipe.dtype)
    spec, cond, uncond, tensors = _cake_batch(pipe, prompts)
    control = P2PControl(dataclasses.replace(spec, uncond_rows=1))
    ctx = torch.cat([uncond[None, 1:].expand(2 * N, -1, -1, -1), cond], dim=1)

    def call(order):
        state = control.init_state(2, heads=pipe.unet.config.num_heads, device="cuda",
                                   images=N)
        with torch.inference_mode():
            eps, _ = apply_images(pipe.unet, x[order], 481, ctx[order], control,
                                  {k: v[order] for k, v in tensors.items()}, state, 5)
        return eps

    ref_out = {}
    handles = _module_outputs(pipe.unet, N, ref_out)
    ref = call(list(range(N)))
    for h in handles:
        h.remove()
    rows = {}
    for label, order in list(ORDERS.items()) + [("moved_no_reduced_bf16_reduction",
                                                 ORDERS["moved"])]:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            not label.endswith("reduction"))
        first = {}
        handles = _module_outputs(pipe.unet, N, first, ref_out, order)
        eps = call(order)
        for h in handles:
            h.remove()
        rows[label] = {
            "order": order,
            "eps_max_abs_by_position": [
                (eps[j].float() - ref[img].float()).abs().max().item() if img < N else None
                for j, img in enumerate(order)],
            "first_differing_module_by_position": {str(j): v for j, v in sorted(first.items())}}
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    del ref_out
    torch.cuda.empty_cache()
    print("unet_call", json.dumps(rows), flush=True)

    # 2. the batched edit
    image = _random_images(2024, pipe.config.image_size)
    imgs = np.stack([image() for _ in range(2 * N)])
    sweep = BatchedDirectInversionP2P(pipe)

    def edit(order):
        spec_o, cond_o, uncond_o, tensors_o = _cake_batch(pipe, [prompts[i] for i in order])
        return sweep.edit_batch(spec_o, imgs[order], cond_o, uncond_o, 7.5, tensors_o)

    first = edit(list(range(N)))
    out = {}
    for label, order in [("again", list(range(N)))] + list(ORDERS.items()):
        got = edit(order)
        out[label] = {"order": order, "uint8_max_recon_edit_by_position": [
            [_diff(g[j], f[img])[0] for g, f in zip(got, first)] if img < N else None
            for j, img in enumerate(order)]}
    print("edit", json.dumps({"steps": args.steps, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
