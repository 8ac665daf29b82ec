"""``directinversion+p2p``: its call structure, the reference's side of the
check and the frozen count, found by the mix's ``"family": "di-p2p"``.

A chunk of N images: DDIM inversion, T calls of N rows; then the edit, T
calls of 3N rows per image [unconditional target, source, target] (4N with
a second unconditional row), DirectInversion re-snapping the source row to
the inversion's trajectory, P2P refine with LocalBlend and reweight; one VAE
encode an image, one decode of 2N rows (reconstruction, edit). The strip is
[text, input, reconstruction, edit].
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import check as C
from perfbench.reference import diffusion as D
from perfbench.reference import text as T


def calls_per_chunk(mix: dict) -> int:
    return 2 * mix["steps"]


@torch.no_grad()
def outputs(ref: C.Reference, calls: List[dict], vae: dict, items: List[dict], n: int,
            mix: dict, strips: Optional[List[str]] = None) -> Dict[str, dict]:
    """Over a chunk of ``n`` images (the real ``items`` first, the rest
    padding): the reference's outputs and, with ``strips`` (the real items'
    files), the program's, from the captured calls and VAE stages. Returns
    {"reference": outputs[, "program": outputs]}."""
    steps = len(ref.sched.timesteps)
    if len(calls) != 2 * steps:
        raise ValueError(f"{len(calls)} UNet calls in the chunk, not {2 * steps}")
    dev, s = ref.device, ref.sched
    full = items + [items[-1]] * (n - len(items))
    src, tgt, blends = ([it[k] for it in full] for k in ("source", "target", "blend"))
    emb = ref.embed([""] + src + tgt)
    e_unc, e_src, e_tgt = emb[:1], emb[1: n + 1], emb[n + 1:]
    mapper, alphas = (torch.as_tensor(np.stack(a), device=dev) for a in
                      zip(*(T.refinement_mapper(a, b, ref.tok) for a, b in zip(src, tgt))))
    use_lb = all(bool(b) for b in blends)
    eq = torch.as_tensor(np.stack([T.equalizer(t, [b[1]], [mix["reweight"]], ref.tok)
                                   for t, b in zip(tgt, blends)]), device=dev) if use_lb else None
    sel = torch.as_tensor(np.stack([T.word_selector([a, b], bl, ref.tok) for a, b, bl in
                                    zip(src, tgt, blends)]), device=dev) if use_lb else None
    alpha_w = torch.as_tensor(T.cross_replace_alpha(steps, mix["cross_replace"]), device=dev)
    window_end, lb_start = int(steps * mix["self_replace"]), int(D.LB_START * steps)
    images = np.stack([C.load_square(it["image"], ref.size) for it in full])
    ext = "." + full[0]["image"].rsplit(".", 1)[-1]

    traj = [C.nchw(c["x"]) for c in calls[:steps]]
    x_edit = [C.nchw(c["x"]) for c in calls[steps:]]
    rows = x_edit[0].shape[0] // n
    if rows not in (3, 4) or any(x.shape[0] != n for x in traj) or vae["dec_in"].shape[0] != 2 * n:
        raise ValueError(f"UNet calls of {traj[0].shape[0]} and {x_edit[0].shape[0]} rows, a "
                         f"decode of {vae['dec_in'].shape[0]}, for {n} images")
    u = rows - 2
    traj.append(C.rows_of(x_edit[0], n)[:, u])  # the inversion's end: the edit's start
    ref_out = {"eps": [], "steps": []}

    def inverse(k, t):
        return lambda eps: (D.ddim_inverse_step(s, eps[:, 0], t, traj[k])[:, None],)

    for k in range(steps):
        t = s.timesteps[steps - 1 - k]
        eps = ref.unet(traj[k], t, e_src)
        ref_out["eps"].append(eps.view(n, 1, *eps.shape[1:]))
        ref_out["steps"].append((k, inverse(k, t), traj[k][:, None]))
    lb: Dict = {}
    ctx = torch.cat([e_unc[None].expand(n, u, -1, -1), e_src[:, None], e_tgt[:, None]], 1)

    def edit(i, t, xi, keep, amb):
        src_next = traj[steps - 1 - i]

        def step(eps):
            guided = D.cfg_mix(eps[:, u - 1], eps[:, u + 1], mix["guidance"])
            return src_next, D.ddim_step(s, guided, t, xi[:, u + 1]), keep, amb
        return step

    for i in range(steps):
        t, x = s.timesteps[i], x_edit[i]
        ctrl = D.P2PAttention(rows, mapper, alphas, eq, alpha_w[i].expand(n, -1),
                              i < window_end, lb if use_lb else None)
        eps = C.rows_of(ref.unet(x, t, ctx.flatten(0, 1), ctrl), n)
        xi = C.rows_of(x, n)
        ref_out["eps"].append(eps)
        keep, amb = torch.ones_like(xi[:, 0, :1]), None
        if use_lb and i + 1 > lb_start:
            top = D.local_blend_maps(lb, sel, x.shape[-1]).amax(dim=1, keepdim=True)
            keep = (top > D.LB_THRESHOLD).float()
            amb = (top - D.LB_THRESHOLD).abs() < C.LB_AMBIGUOUS
        ref_out["steps"].append((steps + i, edit(i, t, xi, keep, amb), xi[:, u:]))
    side = C.vae_side(ref, vae, images, ext)
    ref_out.update(z=side["z"], dec=side["dec"], next=C.own_next(ref_out), panels=[
        C.saved(images, ext), side["decoded"][:n], side["decoded"][n:]])
    out = {"reference": ref_out}
    if strips is not None:
        final = vae["dec_in"].float() * ref.vae.scaling
        dec = C.decoded_u8(vae["dec_out"])
        out["program"] = {
            "eps": [C.rows_of(C.nchw(c["eps"]), n) for c in calls],
            "next": [t[:, None] for t in traj[1:]]
            + [C.rows_of(x, n)[:, u:] for x in x_edit[1:]]
            + [torch.stack([final[:n], final[n:]], 1)],
            **C.program_vae(vae, ref.vae.scaling),
            **C.program_panels(strips, ref.size, [images, dec[:n], dec[n:]], ext)}
    return out


def work(nets: dict, mix: dict, meta) -> tuple:
    """(FLOPs of a chunk, flash list) in the method's call structure: the
    prompts [source, target] of each image and ["", ""] (once a chunk in the
    sweep, once an image in the runner); the first ``int(T * self_replace)``
    edit calls with P2P's replaced self-attention (the source row's
    probabilities applied to the target row's values at maps of at most 32²)."""
    from perfbench import flops as F

    n, steps = mix["batch_per_device"], mix["steps"]
    unet, vae, text = nets["unet"], nets["vae"], nets["text"]
    prompts = 2 * n + (2 if mix["driver"] == "run_sweep" else 2 * n)
    fixed = F.count(lambda: (text(meta.ids(prompts)), vae.encode(meta.img(n)),
                             vae.decode_float(meta.lat(2 * n))))
    inv = F.count(lambda: unet(meta.lat(n), 1, meta.ctx(n)))
    rows = 3 * n
    edit = F.count(lambda: unet(meta.lat(rows), 1, meta.ctx(rows)))
    edit_w = F.count(lambda: unet(meta.lat(rows), 1, meta.ctx(rows), F.SelfReplace(3)))
    window = int(steps * mix["self_replace"])
    total = fixed + steps * inv + (steps - window) * edit + window * edit_w
    return total, F.flash(unet, n, steps) + F.flash(unet, rows, steps)
