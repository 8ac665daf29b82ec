"""Times the port's f32 flash-attention forward (3xTF32 wgmma) against the f32
forward it replaced (FMA on the CUDA cores), in turns, in one process on one
card (python3 scripts/compare_torch_flash_fwd_f32.py --old OLD.cu).

OLD.cu is ``pnpinversion_tpu_torch/csrc/flash_attention_f32.cu`` as it was
when it held that forward, whose C entry ``pnpi_flash_attention_fwd_f32(q, k,
v, o, lse, 12 strides, batch, heads, sq, sk, d, scale, stream)`` is the
forward: ``git show 913521e:pnpinversion_tpu_torch/csrc/flash_attention_f32.cu``
into a git-ignored directory (build/). At each timed f32 shape of
``chip_smoke.FLASH_CASES`` both forwards are checked against the plain
version with TF32 off (the new one at each of its tiles of query rows), then
the new forward (through its wrapper, at each tile, and its split pass
alone), the old one and f32 F.scaled_dot_product_attention are timed in
turns (CUDA events, calls queued behind a spin kernel: no host time
counted). One JSON line per shape, and all of them in
``chiprun_out/compare_flash_fwd_f32.json``. Exits non-zero without CUDA or
when the new forward misses the f32 tolerances.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from pnpinversion_tpu_torch.ops import build  # noqa: E402
from pnpinversion_tpu_torch.ops import flash_attention as fa  # noqa: E402


def load_old(src: Path):
    """nvcc of the old source with the port's flags, its forward's C entry."""
    out = ROOT / "build" / "old_flash_fwd_f32" / "libold_flash_attention_f32.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(build.nvcc_command(src, out), check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).pnpi_flash_attention_fwd_f32
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [ptr] * 5 + [i64] * 12 + [i32] * 5 + [ctypes.c_float, ptr]
    fn.restype = ctypes.c_int
    return fn


def old_forward(fn, q, k, v, scale):
    """The old kernel through the same checks and allocation as the port's
    wrapper, so the two wrappers' host costs compare."""
    fa._no_grad_tracking("old flash_attention_fwd_f32", q, k, v)
    fa._check(q, k, v, torch.float32)
    b, h, sq, d = q.shape
    out = fa._heads_last(b, h, sq, d, q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
             b, h, sq, k.shape[2], d, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"old f32 flash kernel: cudaError {err}")
    return out, lse


def errors(o, lse, o_ref, lse_ref):
    """(O's error relative to max |O|, LSE's largest absolute error)."""
    return chip_smoke._rel(o, o_ref), (lse - lse_ref).abs().max().item()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=Path, required=True,
                        help="flash_attention_f32.cu with the FMA forward")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("compare_torch_flash_fwd_f32: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)
    build.build([fa.F32_FWD_KERNEL])
    old = load_old(args.old)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for name, b, h, sq, sk, d, strided, timed, dtype in chip_smoke.FLASH_CASES:
        if not timed or dtype != "f32":
            continue
        q, k, v = (chip_smoke._heads(gen, b, h, s, d, strided, torch.float32)
                   for s in (sq, sk, sk))
        scale = d ** -0.5
        tiles = (64, 128) if d <= fa.F32_WIDE_TILE_MAX_D else (64,)
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, scale)
        err_new = [max(e) for e in zip(*(errors(*fa._launch_fwd_f32(q, k, v, scale, tile), o_ref,
                                                lse_ref) for tile in tiles))]
        err_old = errors(*old_forward(old, q, k, v, scale), o_ref, lse_ref)
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        fns = {"new_ms": lambda: fa.flash_attention_fwd(q, k, v, scale),
               "old_ms": lambda: old_forward(old, q, k, v, scale),
               "split_ms": lambda: fa.flash_attention_fwd_f32_split(k, v),
               "library_ms": lambda: torch.nn.functional.scaled_dot_product_attention(
                   qc, kc, vc, scale=scale)}
        for tile in tiles:
            fns[f"new_rows{tile}_ms"] = lambda tile=tile: fa._launch_fwd_f32(q, k, v, scale, tile)
        ms = chip_smoke.time_interleaved(fns, reps=args.reps)
        bounds = chip_smoke.f32_flash_bounds(b, h, sq, sk, d)
        row = {"case": name, "shape": [b, h, sq, sk, d],
               "tile_rows": fa.fwd_f32_tile_rows(b * h, sq, d, sms),
               "rel_err_o_new": err_new[0], "max_abs_err_lse_new": err_new[1],
               "rel_err_o_old": err_old[0], "max_abs_err_lse_old": err_old[1],
               **ms, "old_over_new": ms["old_ms"] / ms["new_ms"],
               "new_over_library": ms["new_ms"] / ms["library_ms"],
               "split_share": ms["split_ms"] / ms["new_ms"],
               "bound_ms": bounds["fwd_bound_ms"], "bound_by": bounds["fwd_bound_by"],
               "share_of_bound": bounds["fwd_bound_ms"] / ms["new_ms"],
               "fp32_bound_ms": bounds["fwd_fp32_bound_ms"]}
        print("compare", json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, qc, kc, vc, o_ref, lse_ref
    out = ROOT / "chiprun_out" / "compare_flash_fwd_f32.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    bad = [r["case"] for r in rows if r["rel_err_o_new"] > chip_smoke.F32_O_RTOL
           or r["max_abs_err_lse_new"] > chip_smoke.F32_LSE_ATOL]
    if bad:
        print(f"new f32 forward misses the f32 tolerances at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
