"""Times the port's flash-attention forward kernel against an earlier version
of it, in turns, in one process on one card (python3
scripts/compare_torch_flash_fwd.py --old OLD.cu).

OLD.cu is an earlier ``pnpinversion_tpu_torch/csrc/flash_attention_fwd.cu``
with the C interface it had before the query-tile argument
(``pnpi_flash_attention_fwd_bf16(q, k, v, o, lse, 12 strides, batch, heads,
sq, sk, d, scale, stream)``), or with ``--old-takes-tile`` a variant of the
current kernel with the current interface; e.g. from ``git show <commit>:<that path>``
into a git-ignored directory. At each timed shape of ``chip_smoke.FLASH_CASES``
both kernels are checked against the plain version (the new one at both of
its tiles), then the new kernel (through its wrapper, and at 64- and 128-row
tiles), the old one and F.scaled_dot_product_attention are timed in turns
(CUDA events, calls queued behind a spin kernel: no host time counted), with the host's
microseconds to issue one call of each. One JSON line per shape, and all of
them in ``chiprun_out/compare_flash_fwd.json``.
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


def load_old(src: Path, takes_tile: bool):
    """nvcc of the old source with the port's flags, loaded with ctypes."""
    out = ROOT / "build" / "old_flash_fwd" / "libold_flash_attention_fwd.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(build.nvcc_command(src, out), check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).pnpi_flash_attention_fwd_bf16
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [ptr] * 5 + [i64] * 12 + [i32] * (6 if takes_tile else 5) + [
        ctypes.c_float, ptr]
    fn.restype = ctypes.c_int
    fn.takes_tile = takes_tile
    return fn


def old_forward(fn, q, k, v, scale):
    """The old kernel through the same checks and allocation as the port's
    wrapper, so the two wrappers' host costs compare."""
    fa._no_grad_tracking("old flash_attention_fwd", q, k, v)
    fa._check(q, k, v)
    b, h, sq, d = q.shape
    tile = [fa.fwd_tile_rows(b * h, sq, fa._sm_count(q.device.index))] if fn.takes_tile else []
    out = fa._heads_last(b, h, sq, d, q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
             b, h, sq, k.shape[2], d, *tile, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"old flash kernel: cudaError {err}")
    return out, lse


def errors(o, lse, o_ref, lse_ref):
    return ((o.float() - o_ref.float()).abs().max().item(),
            ((lse - lse_ref).abs() / lse_ref.abs().clamp_min(1.0)).max().item())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=Path, required=True, help="old flash_attention_fwd.cu")
    parser.add_argument("--old-takes-tile", action="store_true",
                        help="OLD.cu has the query-tile argument (a variant of this kernel)")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("compare_torch_flash_fwd: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    build.build([fa.KERNEL])
    old = load_old(args.old, args.old_takes_tile)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for name, b, h, sq, sk, d, strided, timed in chip_smoke.FLASH_CASES:
        if not timed:
            continue
        q, k, v = (chip_smoke._bf16_heads(gen, b, h, s, d, strided) for s in (sq, sk, sk))
        scale = d ** -0.5
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, scale)
        err_new = [max(e) for e in zip(*(errors(*fa._launch_fwd(q, k, v, scale, tile), o_ref,
                                                lse_ref) for tile in (64, 128)))]
        err_old = errors(*old_forward(old, q, k, v, scale), o_ref, lse_ref)
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        ms = chip_smoke.time_interleaved({
            "new_ms": lambda: fa.flash_attention_fwd(q, k, v, scale),
            "old_ms": lambda: old_forward(old, q, k, v, scale),
            "new_rows64_ms": lambda: fa._launch_fwd(q, k, v, scale, 64),
            "new_rows128_ms": lambda: fa._launch_fwd(q, k, v, scale, 128),
            "library_ms": lambda: torch.nn.functional.scaled_dot_product_attention(
                qc, kc, vc, scale=scale),
        }, reps=args.reps)
        bound, bound_by = chip_smoke.flash_bound_ms(b, h, sq, sk, d)
        row = {"case": name, "shape": [b, h, sq, sk, d],
               "tile_rows": fa.fwd_tile_rows(b * h, sq, sms),
               "max_abs_err_o_new": err_new[0], "max_rel_err_lse_new": err_new[1],
               "max_abs_err_o_old": err_old[0], "max_rel_err_lse_old": err_old[1],
               **ms, "old_over_new": ms["old_ms"] / ms["new_ms"],
               "new_over_library": ms["new_ms"] / ms["library_ms"],
               "bound_ms": bound, "bound_by": bound_by}
        print("compare", json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, qc, kc, vc, o_ref, lse_ref
    out = ROOT / "chiprun_out" / "compare_flash_fwd.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"card": chip_smoke.card_line(), "rows": rows}, indent=1))
    bad = [r["case"] for r in rows if r["max_abs_err_o_new"] > chip_smoke.FLASH_O_TOL
           or r["max_rel_err_lse_new"] > chip_smoke.FLASH_LSE_RTOL]
    if bad:
        print(f"new kernel disagrees with the plain version at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
