"""Times the port's flash-attention backward against an earlier version of
it, in turns, in one process on one card (python3
scripts/compare_torch_flash_bwd.py --old OLD.cu).

OLD.cu is an earlier ``pnpinversion_tpu_torch/csrc/flash_attention_bwd.cu``
with the two-kernel C interface (``pnpi_flash_attention_bwd_dq_bf16`` and
``pnpi_flash_attention_bwd_dkv_bf16``, each taking ten pointers and 24
strides), e.g. from ``git show <commit>:<that path>`` into a git-ignored
directory such as ``build/``; or, with ``--variant``, a variant of the current
source with the current interface. At each timed shape of
``chip_smoke.FLASH_BWD_CASES`` both backwards are checked against the plain
backward (the new one at both of its key tiles), then the new backward (as
``FlashAttention`` runs it, and with 64- and 128-key tiles), the old one (dq
then dkv; a variant also at both key tiles) and
F.scaled_dot_product_attention's backward are timed in turns
(CUDA events, calls queued behind a spin kernel: no host time counted), with
the host's microseconds to issue one call of each. One JSON line per shape,
and all of them in the file ``--out`` names (default
``build/compare_flash_bwd.json``).
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


def load_old(src: Path, variant: bool):
    """nvcc of the old source with the port's flags; its (dq, dkv) entries,
    or a variant's bound entries."""
    out = ROOT / "build" / "old_flash_bwd" / "libold_flash_attention_bwd.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(build.nvcc_command(src, out), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    print(f"ptxas {src.name}:", *chip_smoke.ptxas_summary(proc.stdout + proc.stderr),
          sep="\n  ", flush=True)
    lib = ctypes.CDLL(str(out))
    if variant:
        return fa.bind_bwd(lib)
    fns = lib.pnpi_flash_attention_bwd_dq_bf16, lib.pnpi_flash_attention_bwd_dkv_bf16
    for fn in fns:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


def old_backward(fns, q, k, v, out, lse, do, scale, tile_keys=None):
    """(dQ, dK, dV) from the old dq and dkv kernels, with the checks and
    allocations the new wrapper makes, so the two wrappers' host costs
    compare; or from a variant's kernels through the port's wrappers (its
    main kernel at ``tile_keys``, where given)."""
    if not isinstance(fns, tuple):
        saved = fa._bwd_kernels
        fa._bwd_kernels = lambda: fns
        try:
            if tile_keys:
                return new_backward(q, k, v, out, lse, do, scale, tile_keys)
            return fa.flash_attention_bwd(q, k, v, out, lse, do, scale)
        finally:
            fa._bwd_kernels = saved
    fa._check_bwd(q, k, v, lse, do, (("out", out), ("do", do)))
    b, h, sq, d = q.shape
    dq, dk, dv = fa._heads_last(*q.shape, q), fa._heads_last(*k.shape, k), fa._heads_last(
        *v.shape, v)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    tensors = dict(q=q, k=k, v=v, o=out, do=do, dq=dq, dk=dk, dv=dv)
    order = ("q", "k", "v", "o", "do", "dq", "dk", "dv")
    ptrs = (ctypes.c_void_p * 10)(*[tensors[n].data_ptr() for n in order],
                                  lse.data_ptr(), delta.data_ptr())
    strides = (ctypes.c_int64 * 24)(*[s for n in order for s in tensors[n].stride()[:3]])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    for fn in fns:
        err = fn(ptrs, strides, b, h, sq, k.shape[2], d, float(scale), stream)
        if err != 0:
            raise RuntimeError(f"old flash backward kernel: cudaError {err}")
    return dq, dk, dv


def new_backward(q, k, v, out, lse, do, scale, tile_keys):
    """The new backward's three kernels with the main kernel at ``tile_keys``."""
    stats, dq_acc = fa.flash_attention_bwd_prep(out, lse, do)
    dk, dv = fa._launch_bwd_main(q, k, v, do, stats, dq_acc, scale, tile_keys, fa._stream(q))
    return fa.flash_attention_bwd_dq_convert(dq_acc, q, scale), dk, dv


def rel_errors(got, want):
    return max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
               for g, w in zip(got, want))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=Path, required=True, help="old flash_attention_bwd.cu")
    parser.add_argument("--variant", action="store_true",
                        help="OLD.cu has the current C interface (a variant of this kernel)")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "compare_flash_bwd.json",
                        help="where to write all rows as one JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("compare_torch_flash_bwd: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    build.build([fa.KERNEL, fa.BWD_KERNEL])
    old = load_old(args.old, args.variant)
    gen = torch.Generator(device="cuda").manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for name, b, h, sq, sk, d, strided, timed, dtype in chip_smoke.FLASH_BWD_CASES:
        if not timed or dtype != "bf16":
            continue
        q, k, v, do = (chip_smoke._heads(gen, b, h, s, d, strided) for s in (sq, sk, sk, sq))
        scale = d ** -0.5
        out, lse = fa.flash_attention_fwd(q, k, v, scale)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, scale)
        err_new = max(rel_errors(new_backward(q, k, v, out, lse, do, scale, t), want)
                      for t in (64, 128))
        err_old = rel_errors(old_backward(old, q, k, v, out, lse, do, scale), want)
        leaves = [x.detach().contiguous().requires_grad_(True) for x in (q, k, v)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=scale)
        dout = do.contiguous()
        fns = {
            "new_ms": lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, scale),
            "old_ms": lambda: old_backward(old, q, k, v, out, lse, do, scale),
            "new_keys64_ms": lambda: new_backward(q, k, v, out, lse, do, scale, 64),
            "new_keys128_ms": lambda: new_backward(q, k, v, out, lse, do, scale, 128),
            "library_ms": lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True),
        }
        if args.variant:  # the variant at both key tiles too
            fns["old_keys64_ms"] = lambda: old_backward(old, q, k, v, out, lse, do, scale, 64)
            fns["old_keys128_ms"] = lambda: old_backward(old, q, k, v, out, lse, do, scale, 128)
        ms = chip_smoke.time_interleaved(fns, reps=args.reps)
        bound, bound_by = chip_smoke.flash_bwd_bounds(b, h, sq, sk, d)["bwd"]
        row = {"case": name, "shape": [b, h, sq, sk, d],
               "tile_keys": fa.bwd_tile_keys(b * h, sk, sms),
               "rel_err_new": err_new, "rel_err_old": err_old, **ms,
               "old_over_new": ms["old_ms"] / ms["new_ms"],
               "new_over_library": ms["new_ms"] / ms["library_ms"],
               "bound_ms": bound, "bound_by": bound_by}
        print("compare", json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, do, out, lse, want, leaves, lib_out, dout
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": chip_smoke.card_line(), "rows": rows}, indent=1))
    bad = [r["case"] for r in rows if r["rel_err_new"] > chip_smoke.FLASH_BWD_RTOL]
    if bad:
        print(f"new backward disagrees with the plain version at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
