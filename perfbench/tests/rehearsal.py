"""Test helper: drives ``perfbench/run.py``'s ``main`` (and ``control.py``'s)
on the CPU at a tiny size, optionally with a fault planted in the program
under it, and reports the result line. Never a fallback of the measured
command: ``run.py`` itself refuses to run without the card.

    python perfbench/tests/rehearsal.py <cell> [--fault NAME] [--dtype D] [--trace 1]

prints the run's result line, then one line ``FORBIDDEN <json list>``: the
loaded modules whose top-level name is JAX's or the JAX package's.
"""
import argparse
import contextlib
import io
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[0] = ROOT

TINY_MIX = {"images": {"size": 16, "noise_cells": 4, "format": "jpg", "quality": 95},
            "steps": 4, "warmup_steps": 2, "nominal_batch_s": 1.0, "batch_per_device": 2}


def tiny_config() -> dict:
    with open(os.path.join(HERE, "tiny.json")) as f:
        return json.load(f)


def plant(fault: str) -> None:
    """Breaks the program under the harness, in this process."""
    import numpy as np

    from pnpinversion_tpu_torch.editors import bld_editor
    from pnpinversion_tpu_torch.inversion import ddim_inversion
    from pnpinversion_tpu_torch.parallel import sweep
    from pnpinversion_tpu_torch.sampling import p2p_forward

    if fault == "step_unchanged":  # every sampler step returns its input
        def same(schedule, eps, t, sample):
            return sample
        for mod, name in ((p2p_forward, "ddim_step"), (ddim_inversion, "ddim_inverse_step"),
                          (bld_editor, "ddim_step")):
            setattr(mod, name, same)
    elif fault == "half_batch":  # half of each batch edited, the rest copied from it
        for cls in (sweep.BatchedDirectInversionP2P, sweep.BatchedBLD):
            orig = cls.edit_batch

            def edit_batch(self, *args, _orig=orig, **kw):
                args = list(args)
                imgs_at = 1 if isinstance(args[0], sweep.P2PSpec) else 0
                n = len(args[imgs_at])
                keep = max(1, n // 2)
                for i, a in enumerate(args):
                    if hasattr(a, "shape") and len(a.shape) and a.shape[0] == n and n > 1:
                        args[i] = a[:keep]
                    elif isinstance(a, dict):
                        args[i] = {k: v[:keep] for k, v in a.items()}
                out = _orig(self, *args, **kw)
                pad = lambda x: np.concatenate([x, x[:1].repeat(n - keep, 0)])  # noqa: E731
                return tuple(pad(o) for o in out) if isinstance(out, tuple) else pad(out)
            cls.edit_batch = edit_batch
    elif fault == "answer_altered":  # the decoded edit moved by 12 levels where produced
        from pnpinversion_tpu_torch.editors import base

        orig_pair = sweep._decode_pair

        def decode_pair(pipe, a, b):
            recon, edit = orig_pair(pipe, a, b)
            return recon, np.clip(edit.astype(np.int16) + 12, 0, 255).astype(np.uint8)
        sweep._decode_pair = decode_pair
        orig_latent = sweep.latent_to_image

        def latent_to_image(vae, lat):
            out = orig_latent(vae, lat)
            return (out.to(dtype=__import__("torch").int16) + 12).clamp(0, 255).to(out.dtype)
        sweep.latent_to_image = latent_to_image
        orig_dec = base.Editor.decode_image

        def decode_image(self, lat):
            out = orig_dec(self, lat)
            out[-1:] = np.clip(out[-1:].astype(np.int16) + 12, 0, 255).astype(np.uint8)
            return out
        base.Editor.decode_image = decode_image
    elif fault == "decoder_altered":  # the VAE decoder's output moved where produced
        from pnpinversion_tpu_torch.models import vae

        orig_decode = vae.VAE.decode

        def decode(self, lat):
            h = self.decoder.conv_out.register_forward_hook(lambda m, a, out: out + 0.1,
                                                            prepend=True)
            try:
                return orig_decode(self, lat)
            finally:
                h.remove()
        vae.VAE.decode = decode
    elif fault:
        raise ValueError(f"unknown fault {fault!r}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("cell")
    p.add_argument("--fault", default="")
    p.add_argument("--dtype", default="")
    p.add_argument("--trace", default="0")
    p.add_argument("--seed", default="3000000017")
    p.add_argument("--batch", type=int, default=2)
    args = p.parse_args()
    from perfbench import harness, run

    mix = dict(TINY_MIX, batch_per_device=args.batch, **({"dtype": args.dtype} if args.dtype else {}))
    if args.fault:
        plant(args.fault)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(["--workload", args.cell, "--seed", args.seed, "--seconds", "2",
                       "--trace", args.trace],
                      rehearsal={"device": "cpu", "config": tiny_config(), "mix": mix})
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    print(lines[-1] if lines else "{}")
    print("RC", rc)
    print("FORBIDDEN", json.dumps(harness.forbidden_modules(sys.modules)))


if __name__ == "__main__":
    main()
