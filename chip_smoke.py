"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (python3 chip_smoke.py).

Phases, each of which raises on failure (the script then exits non-zero):
1. the card's name and power limit, torch/CUDA versions, TF32 flags;
2. build every CUDA kernel of the port from the sources in this checkout;
3. hold each kernel against its plain PyTorch version at the main path's
   shapes (and a few more), and time kernel, plain version and the PyTorch
   library call that computes the same function, with CUDA events;
4. drive the main path: ``P2PEditor("directinversion+p2p", ...)`` on an SD1.4
   pipeline at full width (random weights from a seed, bf16, 512², 50 DDIM
   steps), a warm-up edit, a timed edit whose kernel launches are counted,
   and a per-phase timed edit whose latents are checked;
5. print one JSON line of kernel numbers, then the result line.

It imports nothing of JAX and nothing of the JAX package. Without CUDA it
exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, SXM, 700 W
H100_BYTES_PER_S = 3.35e12  # HBM3

# (name, B, H, Sq, Sk, D, strided, timed): strided inputs are heads split from
# a (B, S, H*D) tensor, as the UNet's attention sites make them
FLASH_CASES = [
    ("scan_64x64", 3, 8, 4096, 4096, 40, True, True),
    ("scan_32x32", 3, 8, 1024, 1024, 80, True, True),
    ("invert_64x64", 1, 8, 4096, 4096, 40, True, True),
    ("invert_32x32", 1, 8, 1024, 1024, 80, True, True),
    ("d64_s1024", 1, 8, 1024, 1024, 64, False, False),
    ("ragged_cross", 1, 8, 1000, 77, 40, False, False),
]
FLASH_O_TOL = 1e-2      # |v| ~ N(0,1): O is a convex mix of v; bf16 rounding of O and P
FLASH_LSE_RTOL = 1e-3   # f32 statistics on both sides
EXPECTED_FLASH_LAUNCHES = 1000  # 10 sites x (50 inversion + 50 scan) UNet calls


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_interleaved(fns: dict, reps: int = 20, warmup: int = 3) -> dict:
    """Median CUDA-event milliseconds of each callable, run in turns."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    times = {k: [] for k in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times[name].append(e0.elapsed_time(e1))
    return {k: statistics.median(v) for k, v in times.items()}


def flash_bound_ms(b, h, sq, sk, d) -> tuple:
    flops = 4.0 * b * h * sq * sk * d
    nbytes = 2.0 * b * h * (2 * sq * d + 2 * sk * d) + 4.0 * b * h * sq
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_phase() -> dict:
    """Kernel vs plain version at every case; times at the timed cases."""
    from pnpinversion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], 0.0
    for name, b, h, sq, sk, d, strided, timed in FLASH_CASES:
        def make(s):
            if strided:
                x = torch.randn((b, s, h * d), generator=gen, device="cuda")
                return x.to(torch.bfloat16).view(b, s, h, d).transpose(1, 2)
            return torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)

        q, k, v = make(sq), make(sk), make(sk)
        scale = d ** -0.5
        o, lse = fa.flash_attention_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, scale)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = ((lse - lse_ref).abs() / lse_ref.abs().clamp_min(1.0)).max().item()
        ok = err_o <= FLASH_O_TOL and err_lse <= FLASH_LSE_RTOL
        row = {"case": name, "shape": [b, h, sq, sk, d], "max_abs_err_o": err_o,
               "max_rel_err_lse": err_lse, "ok": ok}
        if timed:
            qc, kc, vc = (x.contiguous() for x in (q, k, v))
            ms = time_interleaved({
                "ms": lambda: fa.flash_attention_fwd(q, k, v, scale),
                "plain_ms": lambda: fa.flash_attention_reference(q, k, v, scale),
                "library_ms": lambda: torch.nn.functional.scaled_dot_product_attention(
                    qc, kc, vc, scale=scale),
            })
            bound, bound_by = flash_bound_ms(b, h, sq, sk, d)
            row.update(ms, bound_ms=bound, bound_by=bound_by)
        print("flash", json.dumps(row), flush=True)
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain version: {row}")
        worst = max(worst, err_o)
        rows.append(row)
        del q, k, v, o, lse, o_ref, lse_ref
    torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": worst}


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main_path_phase(steps: int = 50) -> dict:
    """SD1.4 directinversion+p2p at full width on the card, through the
    port's entry points."""
    from pnpinversion_tpu_torch.configs import SD14
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor
    from pnpinversion_tpu_torch.ops import flash_attention as fa
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    pipe, t_create = _sync_time(lambda: SDPipeline.create(SD14, seed=0, num_ddim_steps=steps))
    assert pipe.device.type == "cuda" and pipe.dtype == torch.bfloat16
    editor = P2PEditor(pipe)
    rng = np.random.RandomState(1234)
    src = "a round cake with orange frosting on a wooden plate"
    tar = "a square cake with orange frosting on a wooden plate"
    kwargs = dict(guidance_scale=7.5, blend_word=(("cake",), ("cake",)),
                  eq_params={"words": ("square",), "values": (2.0,)})

    def image():
        return (rng.rand(512, 512, 3) * 255).astype(np.uint8)

    _, t_warm = _sync_time(lambda: editor("directinversion+p2p", image(), src, tar, **kwargs))
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = 0
    strip, t_edit = _sync_time(lambda: editor("directinversion+p2p", image(), src, tar, **kwargs))
    launches = fa.flash_attention_fwd.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if strip.shape != (512, 2048, 3) or strip.dtype != np.uint8:
        raise AssertionError(f"strip {strip.shape} {strip.dtype}, want (512, 2048, 3) uint8")
    if launches != EXPECTED_FLASH_LAUNCHES * steps // 50:
        raise AssertionError(f"flash kernel launched {launches} times in one edit, "
                             f"want {EXPECTED_FLASH_LAUNCHES * steps // 50}")

    # the same edit phase by phase, each timed to a synchronize
    with torch.inference_mode():
        img = image()
        latent, t_enc = _sync_time(lambda: editor.encode_image(img))
        (cond, uncond), t_text = _sync_time(lambda: editor.embeds([src, tar]))
        traj, t_inv = _sync_time(lambda: editor.invert(latent, cond[:1]))
        spec, tensors = editor.make_control([src, tar], blend_word=kwargs["blend_word"],
                                            eq_params=kwargs["eq_params"])
        edit, t_scan = _sync_time(lambda: editor.fused_edit(spec, traj, cond, uncond, 7.5,
                                                            tensors))
        both, t_dec = _sync_time(lambda: editor.decode_image(torch.cat([traj[0], edit[-1:]])))
    for name, x in (("trajectory", traj), ("edit latents", edit)):
        if not torch.isfinite(x).all():
            raise AssertionError(f"{name} are not finite")
    if traj.shape != (steps + 1, 1, 64, 64, 4) or edit.shape != (2, 64, 64, 4):
        raise AssertionError(f"latent shapes {tuple(traj.shape)}, {tuple(edit.shape)}")
    if both.shape != (2, 512, 512, 3):
        raise AssertionError(f"decoded {both.shape}")
    return {"create_s": t_create, "warmup_edit_s": t_warm, "edit_s_per_image": t_edit,
            "flash_launches_per_edit": launches, "peak_mem_gib": peak_gib,
            "vae_encode_x1_s": t_enc, "text_encode_s": t_text,
            f"invert_{steps}xb1_s": t_inv, f"fused_offsets_edit_{steps}xb3_s": t_scan,
            "vae_decode_x2_s": t_dec}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pnpinversion_tpu_torch.ops import build
    from pnpinversion_tpu_torch.ops.flash_attention import KERNEL

    print(card_line(), flush=True)  # name, power limit: as nvidia-smi prints them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    build_s = build.build([KERNEL])
    print(f"build: {json.dumps(build_s)} total {time.perf_counter() - t0:.1f}s", flush=True)
    print(build.build_log(KERNEL), flush=True)

    flash = kernel_phase()
    main_path = main_path_phase()
    print("main_path", json.dumps(main_path), flush=True)

    head = next(r for r in flash["rows"] if r["case"] == "scan_64x64")
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "pnpinversion_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "pnpinversion_tpu/ops/flash_attention.py:60",
        "launches": main_path["flash_launches_per_edit"],
        "max_abs_err": flash["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": head["shape"], "per_case": flash["rows"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
