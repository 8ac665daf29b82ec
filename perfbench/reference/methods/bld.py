"""Blended Latent Diffusion (``blended-latent-diffusion``): its call
structure, the reference's side of the check and the frozen count, found by
the mix's ``"family": "bld"``.

A chunk of N images: the target prompts and "" encoded once; one VAE encode
an image; T - int(T * blending_percentage) guided calls of 2N rows, each
step blending the background back from the freshly noised source latents
under the item's mask; one decode of N rows. The strip is [text, input,
zeros, edit].
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import check as C
from perfbench.reference import diffusion as D


def calls_per_chunk(mix: dict) -> int:
    steps = mix["steps"]
    return steps - int(steps * mix["blending_percentage"])


@torch.no_grad()
def outputs(ref: C.Reference, calls: List[dict], vae: dict, items: List[dict], n: int,
            mix: dict, strips: Optional[List[str]] = None) -> Dict[str, dict]:
    """As ``di-p2p``'s. The noise is the method's: a generator seeded
    ``mix["noise_seed"]`` on the program's device draws the start latents,
    then one draw a step, each of one image's (1, h, w, 4) and shared by the
    chunk's images."""
    steps = len(ref.sched.timesteps)
    start = int(steps * mix["blending_percentage"])
    if len(calls) != steps - start:
        raise ValueError(f"{len(calls)} UNet calls in the chunk, not {steps - start}")
    dev, s = ref.device, ref.sched
    full = items + [items[-1]] * (n - len(items))
    emb = ref.embed([""] + [it["target"] for it in full])
    ctx = torch.stack([emb[:1].expand(n, -1, -1), emb[1:]], 1).flatten(0, 1)
    images = np.stack([C.load_bilinear(it["image"], ref.size) for it in full])
    ext = "." + full[0]["image"].rsplit(".", 1)[-1]
    latent = calls[0]["x"].shape[1]
    mask = torch.as_tensor(np.stack([C.latent_mask(it["mask"], latent) for it in full]),
                           device=dev)[:, None, None]
    gen = torch.Generator(device=dev).manual_seed(mix["noise_seed"])

    def noise():
        return torch.randn((1, latent, latent, 4), generator=gen, device=dev).permute(0, 3, 1, 2)

    xs = [C.rows_of(C.nchw(c["x"]), n) for c in calls]
    if xs[0].shape[1] != 2 or vae["dec_in"].shape[0] != n:
        raise ValueError(f"a BLD call of {calls[0]['x'].shape[0]} rows, a decode of "
                         f"{vae['dec_in'].shape[0]}, for {n} images")
    side = C.vae_side(ref, vae, images, ext)
    z = side["z"][:, None]
    x0 = noise()[:, None].expand(n, 1, -1, -1, -1)
    ref_out = {"eps": [], "steps": [(None, lambda eps: (x0,), None)]}

    def blend(t, lat, fresh):
        def step(eps):
            stepped = D.ddim_step(s, D.cfg_mix(eps[:, :1], eps[:, 1:], mix["guidance"]), t, lat)
            return (stepped * mask + D.add_noise(s, z, fresh, t) * (1 - mask),)
        return step

    for i in range(steps - start):
        t = s.timesteps[start + i]
        ref_out["eps"].append(C.rows_of(ref.unet(xs[i].flatten(0, 1), t, ctx), n))
        ref_out["steps"].append((i, blend(t, xs[i][:, 1:], noise()), xs[i][:, 1:]))
    zeros = np.zeros_like(images)
    ref_out.update(z=side["z"], dec=side["dec"], next=C.own_next(ref_out), panels=[
        C.saved(images, ext), C.saved(zeros, ext), side["decoded"]])
    out = {"reference": ref_out}
    if strips is not None:
        out["program"] = {
            "eps": [C.rows_of(C.nchw(c["eps"]), n) for c in calls],
            "next": [x[:, 1:] for x in xs] + [vae["dec_in"].float()[:, None] * ref.vae.scaling],
            **C.program_vae(vae, ref.vae.scaling),
            **C.program_panels(strips, ref.size, [images, zeros, C.decoded_u8(vae["dec_out"])],
                               ext)}
    return out


def work(nets: dict, mix: dict, meta) -> tuple:
    """(FLOPs of a chunk, flash list) in the method's call structure."""
    from perfbench import flops as F

    n, calls = mix["batch_per_device"], calls_per_chunk(mix)
    unet, vae, text = nets["unet"], nets["vae"], nets["text"]
    fixed = F.count(lambda: (text(meta.ids(n + 1)), vae.encode(meta.img(n)),
                             vae.decode_float(meta.lat(n))))
    total = fixed + calls * F.count(lambda: unet(meta.lat(2 * n), 1, meta.ctx(2 * n)))
    return total, F.flash(unet, 2 * n, calls)
