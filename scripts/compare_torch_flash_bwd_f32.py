"""Times the port's f32 flash-attention backward (3xTF32 wgmma, each kernel
after its split pass) against the f32 backward it replaced (FMA on the CUDA
cores), in turns, in one process on one card
(python3 scripts/compare_torch_flash_bwd_f32.py --old OLD.cu).

OLD.cu is ``pnpinversion_tpu_torch/csrc/flash_attention_f32.cu`` as it was
when it held that backward, whose C entry ``pnpi_flash_attention_bwd_f32(q,
k, v, dout, lse, delta, dq, dk, dv, 21 strides, batch, heads, sq, sk, d,
scale, dq_only, stream)`` runs its dQ or dK/dV kernel:
``git show 41ddbb0:pnpinversion_tpu_torch/csrc/flash_attention_f32.cu`` into
a git-ignored directory (build/). At each timed f32 backward shape of
``chip_smoke.FLASH_BWD_CASES`` both backwards are checked against the plain
version with TF32 off (the new one at each of its tiles of rows), then the
whole backward (delta, then dQ and dK/dV) of each, each one's dQ and dK/dV
alone (the new ones with their split passes), the new split passes alone,
the new kernels at each tile of rows and f32
F.scaled_dot_product_attention's backward are timed in turns (CUDA events,
calls queued behind a spin kernel: no host time counted). One JSON line per
shape, and all of them in ``chiprun_out/compare_flash_bwd_f32.json``. Exits
non-zero without CUDA or when the new backward misses ``F32_BWD_RTOL``.
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
    """nvcc of the old source with the port's flags, its backward's C entry."""
    out = ROOT / "build" / "old_flash_bwd_f32" / "libold_flash_attention_f32.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(build.nvcc_command(src, out), check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).pnpi_flash_attention_bwd_f32
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [ptr] * 9 + [i64] * 21 + [i32] * 5 + [ctypes.c_float, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def old_kernel(fn, q, k, v, do, lse, delta, scale, dq_only: bool):
    """The old dQ (``dq_only``) or dK/dV kernel through the same checks and
    allocation as the port's wrappers, so the wrappers' host costs compare."""
    fa._check(q, k, v, torch.float32)
    fa._check_like(q, (("do", do),))
    fa._check_stats(q, lse, delta)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dq = fa._heads_last(b, h, sq, d, q) if dq_only else q
    dk, dv = (k, v) if dq_only else (fa._heads_last(b, h, sk, d, k), fa._heads_last(b, h, sk, d, v))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *q.stride()[:3],
             *k.stride()[:3], *v.stride()[:3], *do.stride()[:3], *dq.stride()[:3],
             *dk.stride()[:3], *dv.stride()[:3], b, h, sq, sk, d, float(scale), int(dq_only),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"old f32 flash backward kernel: cudaError {err}")
    return dq if dq_only else (dk, dv)


def old_backward(fn, q, k, v, out, lse, do, scale):
    """The old whole backward as ``flash_attention_bwd`` ran it: delta, then
    the dQ and the dK/dV kernel."""
    delta = (do * out).sum(dim=-1).contiguous()
    return ((old_kernel(fn, q, k, v, do, lse, delta, scale, True),)
            + old_kernel(fn, q, k, v, do, lse, delta, scale, False))


def errors(got, want) -> float:
    """The largest of dQ's, dK's and dV's error relative to max |plain|."""
    return max(chip_smoke._rel(g, w) for g, w in zip(got, want))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=Path, required=True,
                        help="flash_attention_f32.cu with the FMA backward")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("compare_torch_flash_bwd_f32: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)
    build.build([fa.F32_FWD_KERNEL, fa.F32_BWD_KERNEL])
    old = load_old(args.old)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for name, b, h, sq, sk, d, strided, timed, dtype in chip_smoke.FLASH_BWD_CASES:
        if not timed or dtype != "f32":
            continue
        q, k, v, do = (chip_smoke._heads(gen, b, h, s, d, strided, torch.float32)
                       for s in (sq, sk, sk, sq))
        scale = d ** -0.5
        out, lse = fa.flash_attention_fwd(q, k, v, scale)
        delta = (do * out).sum(dim=-1).contiguous()
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, scale)
        tiles = {kern: (64, 128) if d <= fa.F32_BWD_WIDE_TILE_MAX_D[kern] else (64,)
                 for kern in ("dq", "dkv")}
        err_new = max(errors((fa._launch_bwd_f32(q, k, v, do, lse, delta, scale, True, r1),)
                             + fa._launch_bwd_f32(q, k, v, do, lse, delta, scale, False, r2),
                             want)
                      for r1 in tiles["dq"] for r2 in tiles["dkv"])
        err_old = errors(old_backward(old, q, k, v, out, lse, do, scale), want)
        leaves = [x.detach().contiguous().requires_grad_(True) for x in (q, k, v)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=scale)
        dout = do.contiguous()
        fns = {"new_bwd_ms": lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, scale),
               "old_bwd_ms": lambda: old_backward(old, q, k, v, out, lse, do, scale),
               "new_dq_ms": lambda: fa.flash_attention_bwd_dq_f32(q, k, v, do, lse, delta, scale),
               "old_dq_ms": lambda: old_kernel(old, q, k, v, do, lse, delta, scale, True),
               "new_dkv_ms": lambda: fa.flash_attention_bwd_dkv_f32(q, k, v, do, lse, delta,
                                                                    scale),
               "old_dkv_ms": lambda: old_kernel(old, q, k, v, do, lse, delta, scale, False),
               "split_dq_ms": lambda: fa.flash_attention_bwd_f32_split(k, v),
               "split_dkv_ms": lambda: fa.flash_attention_bwd_f32_split(q, do, lse, delta),
               "library_bwd_ms": lambda: torch.autograd.grad(lib_out, leaves, dout,
                                                             retain_graph=True)}
        for kern, rows_ in tiles.items():
            for r in rows_:
                fns[f"new_{kern}_rows{r}_ms"] = (
                    lambda kern=kern, r=r: fa._launch_bwd_f32(q, k, v, do, lse, delta, scale,
                                                              kern == "dq", r))
        ms = chip_smoke.time_interleaved(fns, reps=args.reps)
        bounds = chip_smoke.f32_flash_bounds(b, h, sq, sk, d)
        row = {"case": name, "shape": [b, h, sq, sk, d],
               "tile_rows": {kern: fa.bwd_f32_tile_rows(kern, b * h, sq if kern == "dq" else sk,
                                                        d, sms) for kern in ("dq", "dkv")},
               "rel_err_new": err_new, "rel_err_old": err_old, **ms,
               "old_over_new": ms["old_bwd_ms"] / ms["new_bwd_ms"],
               "old_over_new_dq": ms["old_dq_ms"] / ms["new_dq_ms"],
               "old_over_new_dkv": ms["old_dkv_ms"] / ms["new_dkv_ms"],
               "new_over_library": ms["new_bwd_ms"] / ms["library_bwd_ms"],
               "old_over_library": ms["old_bwd_ms"] / ms["library_bwd_ms"],
               "split_share": (ms["split_dq_ms"] + ms["split_dkv_ms"]) / ms["new_bwd_ms"],
               **{f"{key}_bound_ms": bounds[f"{key}_bound_ms"]
                  for key in ("bwd", "dq", "dkv", "bwd_fp32", "dq_fp32", "dkv_fp32")},
               "share_of_bound": bounds["bwd_bound_ms"] / ms["new_bwd_ms"],
               "dq_share_of_bound": bounds["dq_bound_ms"] / ms["new_dq_ms"],
               "dkv_share_of_bound": bounds["dkv_bound_ms"] / ms["new_dkv_ms"]}
        print("compare", json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, do, out, lse, delta, want, leaves, lib_out, dout
        torch.cuda.empty_cache()
    path = ROOT / "chiprun_out" / "compare_flash_bwd_f32.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    bad = [r["case"] for r in rows if r["rel_err_new"] > chip_smoke.F32_BWD_RTOL]
    if bad:
        print(f"new f32 backward misses F32_BWD_RTOL at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
