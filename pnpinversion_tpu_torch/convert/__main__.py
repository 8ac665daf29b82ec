"""Check a directory of local weights before a run (the counterpart of the JAX
package's ``python -m pnpinversion_tpu.convert``):

    python -m pnpinversion_tpu_torch.convert --root CKPTS [--manifest OUT.json] [--device cpu]

It takes the JAX CLI's layout and flags (each path flag overrides one entry
of the layout under ``--root``):

    root/
      unet/ vae/ text_encoder/ [tokenizer/]   SD1.4 (--sd14; or root/sd14/)
      sd21/                                   SD2.1 (--sd21)
      *ip2p*.ckpt / *instruct-pix2pix*.ckpt   InstructPix2Pix (--ip2p)
      *instructdiffusion*.ckpt                InstructDiffusion (--instructdiffusion)
      clip/ dino/ lpips/ blip/                metric models, BLIP (--clip ...)

For each family it finds it loads every module strictly (every key of the
files consumed or in the documented ignore set, every parameter filled),
runs a forward smoke on a fixed input that must give finite outputs, and
records both in a JSON manifest (default ``<root>/conversion_manifest.json``).
The JAX CLI's last step, caching the converted trees with orbax, has no
counterpart: the port loads the source files directly each time. Runs on
``cuda`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional

import torch

from pnpinversion_tpu_torch.configs import CLIPTextConfig, IP2P, SD14, SD21, StableDiffusionConfig
from pnpinversion_tpu_torch.convert import checkpoint as ck
from pnpinversion_tpu_torch.convert.state_dict import KNOWN_IGNORED_KEYS, load_pipeline_part
from pnpinversion_tpu_torch.models import vit
from pnpinversion_tpu_torch.models.blip import BLIP_VIT_B16_384, BlipTextConfig
from pnpinversion_tpu_torch.utils.device import resolve_device

# the metric models' configs (module globals, so a test can shrink them)
CLIP_VISION = vit.CLIP_VIT_L14
CLIP_TEXT = CLIPTextConfig()
DINO = vit.DINO_VITB8
BLIP_VISION = BLIP_VIT_B16_384
BLIP_TEXT = BlipTextConfig()


def _stats(x: torch.Tensor, what: str) -> Dict[str, Any]:
    x = x.float()
    if not torch.isfinite(x).all():
        raise ValueError(f"{what}: the forward smoke gave non-finite values")
    return {"mean": float(x.mean()), "std": float(x.std(correction=0)), "shape": list(x.shape)}


def _filled(module: torch.nn.Module) -> int:
    return len(module.state_dict())


@torch.inference_mode()
def _pipeline_smoke(modules: dict, config: StableDiffusionConfig, device) -> dict:
    s = min(config.unet.sample_size, 32)
    x = torch.full((1, s, s, config.unet.in_channels), 0.1, device=device)
    ctx = torch.full((1, 77, config.unet.context_dim), 0.02, device=device)
    eps, _ = modules["unet"](x, 500, ctx)
    img = torch.full((1, 64, 64, 3), 0.25, device=device)
    mean, _ = modules["vae"].encode_moments(img)
    dec = modules["vae"].decode(mean * config.vae.scaling_factor)
    ids = (torch.arange(77, device=device) % config.text.vocab_size)[None]
    text = modules["text"](ids)
    return {"unet": _stats(eps, "unet"), "vae": _stats(dec, "vae"), "text": _stats(text, "text")}


def check_pipeline(source: str, config: StableDiffusionConfig, device) -> Dict[str, Any]:
    """An HF pipeline directory or a CompVis .ckpt -> its report: keys per
    module (total, ignored), tensors filled, the forward smoke's output
    statistics."""
    (kind, path), sds = ck.pipeline_state_dicts(source, config)
    report: Dict[str, Any] = {"source": path, "layout": kind, "config": config.name}
    modules = {}
    for part, module in ck.empty_pipeline_modules(config).items():
        sd = sds[part]
        modules[part] = load_pipeline_part(module, part, sd, torch.float32, device,
                                           what=f"{path} {part}")
        ignored = sum(1 for k in sd if k in KNOWN_IGNORED_KEYS)
        report[part] = {"keys_total": len(sd), "keys_ignored": ignored,
                        "keys_consumed": len(sd) - ignored, "tensors_filled": _filled(module)}
    for part, stats in _pipeline_smoke(modules, config, device).items():
        report[part]["forward"] = stats
    return report


@torch.inference_mode()
def check_metrics(root: str, device, clip=None, dino=None, lpips=None,
                  blip=None) -> Dict[str, Any]:
    """clip/ dino/ lpips/ blip/ (each optional) -> their reports."""
    report: Dict[str, Any] = {}
    clip = clip or os.path.join(root, "clip")
    if os.path.isdir(clip):
        m = ck.load_clip_modules(clip, CLIP_VISION, CLIP_TEXT, device)
        size = CLIP_VISION.image_size
        emb, _ = m["clip_vision"](torch.zeros((1, size, size, 3), device=device))
        ids = (torch.arange(77, device=device) % CLIP_TEXT.vocab_size)[None]
        text = m["clip_text_proj"](m["clip_text"](ids)[:, -1])
        report["clip"] = {"source": clip, **{k: {"tensors_filled": _filled(v)}
                                             for k, v in m.items()},
                          "forward": {"image": _stats(emb, "clip vision"),
                                      "text": _stats(text, "clip text")}}
    dino = dino or os.path.join(root, "dino")
    if os.path.isdir(dino):
        m = ck.load_dino_module(dino, DINO, device)
        size = DINO.image_size
        tokens, _ = m(torch.zeros((1, size, size, 3), device=device), return_tokens=True)
        report["dino"] = {"source": dino, "tensors_filled": _filled(m),
                          "forward": _stats(tokens, "dino")}
    lpips = lpips or os.path.join(root, "lpips")
    if os.path.isdir(lpips):
        m = ck.load_lpips_module(lpips, device)
        a = torch.zeros((1, 64, 64, 3), device=device)
        report["lpips"] = {"source": lpips, "tensors_filled": _filled(m),
                           "forward": _stats(m(a, a + 0.5), "lpips")}
    blip = blip or os.path.join(root, "blip")
    if os.path.isdir(blip):
        vision, decoder = ck.load_blip_modules(blip, BLIP_VISION, BLIP_TEXT, device)
        size = BLIP_VISION.image_size
        tokens, _ = vision(torch.zeros((1, size, size, 3), device=device), return_tokens=True)
        ids = torch.arange(4, device=device)[None] % BLIP_TEXT.vocab_size
        logits = decoder(ids, tokens)
        report["blip"] = {"source": blip, "vision_tensors_filled": _filled(vision),
                          "decoder_tensors_filled": _filled(decoder),
                          "tokenizer": ck.blip_tokenizer_file(root),
                          "forward": {"vision": _stats(tokens, "blip vision"),
                                      "decoder": _stats(logits, "blip decoder")}}
    return report


def _find_ckpt(root: str, patterns) -> Optional[str]:
    if not os.path.isdir(root):
        return None
    found = [f for f in sorted(os.listdir(root)) if f.endswith(".ckpt")
             and any(p in f for p in patterns)]
    return os.path.join(root, found[0]) if found else None


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m pnpinversion_tpu_torch.convert",
                                 description="load and check every model family's weights")
    ap.add_argument("--root", type=str, default=None,
                    help="checkpoint root (the layout in the module doc)")
    ap.add_argument("--sd14", type=str, default=None,
                    help="HF SD1.4 pipeline dir (default: --root itself, or root/sd14)")
    ap.add_argument("--sd21", type=str, default=None)
    ap.add_argument("--ip2p", type=str, default=None, help="CompVis instruct-pix2pix .ckpt")
    ap.add_argument("--instructdiffusion", type=str, default=None,
                    help="CompVis InstructDiffusion .ckpt")
    ap.add_argument("--clip", type=str, default=None)
    ap.add_argument("--dino", type=str, default=None)
    ap.add_argument("--lpips", type=str, default=None)
    ap.add_argument("--blip", type=str, default=None)
    ap.add_argument("--manifest", type=str, default=None,
                    help="output JSON (default <root>/conversion_manifest.json)")
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    root = args.root or "."
    manifest: Dict[str, Any] = {"root": os.path.abspath(root), "models": {}}
    models = manifest["models"]
    sd14 = args.sd14 or (root if os.path.isdir(os.path.join(root, "unet"))
                         else os.path.join(root, "sd14"))
    sd21 = args.sd21 or os.path.join(root, "sd21")
    for name, path, config in (("sd14", sd14, SD14), ("sd21", sd21, SD21)):
        if os.path.isdir(os.path.join(path, "unet")):
            models[name] = check_pipeline(path, config, device)
            print(f"[convert] {name}: ok", flush=True)
        else:
            models[name] = {"skipped": f"no HF dir at {path}"}
    for name, path, patterns in (("ip2p", args.ip2p, ("ip2p", "instruct-pix2pix")),
                                 ("instructdiffusion", args.instructdiffusion,
                                  ("instructdiffusion", "v1-5-pretrained"))):
        path = path or _find_ckpt(root, patterns)
        if path and os.path.isfile(path):
            models[name] = check_pipeline(path, IP2P, device)
            print(f"[convert] {name}: ok", flush=True)
        else:
            models[name] = {"skipped": "no .ckpt found"}
    models["metrics"] = check_metrics(root, device, clip=args.clip, dino=args.dino,
                                      lpips=args.lpips, blip=args.blip)
    print(f"[convert] metrics: {sorted(models['metrics'])}", flush=True)
    out_path = args.manifest or os.path.join(root, "conversion_manifest.json")
    with open(out_path, "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"[convert] manifest -> {out_path}", flush=True)
    return manifest


if __name__ == "__main__":
    main()
