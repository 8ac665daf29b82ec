"""How far 3xTF32 products on the tensor cores land from the f32 attention
forward (python3 scripts/probe_3xtf32_error.py), before a 3xTF32 kernel is
trusted with the f32 tolerances of ``chip_smoke.py`` (O within
``F32_O_RTOL`` of max |O|, LSE within ``F32_LSE_ATOL``).

At every f32 case of ``chip_smoke.FLASH_CASES`` the operands are split with
``flash_attention.tf32_split`` (hi = TF32 rounding of x, lo = x - hi) and
each product is taken as hi hi + hi lo + lo hi with ``torch.matmul`` and TF32
on (cuBLAS on the tensor cores). Three ways of doing so are held against the
plain version with TF32 off:

- ``one_tf32``: one TF32 product each for QK^T and PV (what plain TF32 gives);
- ``three_tf32``: 3xTF32 for QK^T and for PV, PV summed over all keys in
  one product (the accumulator carries every key);
- ``three_tf32_tiled``: 3xTF32, PV summed by tiles of ``tile_keys(d)`` keys,
  each tile's product from zero, the tiles added in f32 (the kernel's
  two-level accumulation), small terms issued before hi hi.

One JSON line per case and all of them in ``chiprun_out/probe_3xtf32.json``.
Exits non-zero without CUDA. A probe: it fails on no tolerance.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from pnpinversion_tpu_torch.ops import flash_attention as fa  # noqa: E402


def _three(a, b):
    """a @ b as 3xTF32: small terms first, hi hi last (TF32 must be on)."""
    a_hi, a_lo = fa.tf32_split(a)
    b_hi, b_lo = fa.tf32_split(b)
    return a_hi @ b_lo + a_lo @ b_hi + a_hi @ b_hi


def forward(q, k, v, scale, mode: str, keys: int):
    """(O, LSE) with the products taken as ``mode`` says."""
    kt = k.transpose(-1, -2)
    s = (q @ kt if mode == "one_tf32" else _three(q, kt)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    lse = (m + torch.log(l))[..., 0]
    if mode == "one_tf32":
        o = p @ v
    elif mode == "three_tf32":
        o = _three(p, v)
    else:
        o = torch.zeros_like(q)
        for j in range(0, k.shape[-2], keys):
            o += _three(p[..., j:j + keys], v[..., j:j + keys, :])
    return o / l, lse


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_3xtf32_error: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    modes = ("one_tf32", "three_tf32", "three_tf32_tiled")
    rows = []
    for name, b, h, sq, sk, d, strided, _, dtype in chip_smoke.FLASH_CASES:
        if dtype != "f32":
            continue
        q, k, v = (chip_smoke._heads(gen, b, h, s, d, strided, torch.float32)
                   for s in (sq, sk, sk))
        scale = d ** -0.5
        row = {"case": name, "shape": [b, h, sq, sk, d], "tile_keys": fa.fwd_f32_tile_keys(d)}
        for mode in modes:
            worst_o, worst_lse = 0.0, 0.0
            for i in range(b):  # one batch row (8 heads) at a time bounds the memory
                qi, ki, vi = q[i:i + 1], k[i:i + 1], v[i:i + 1]
                torch.backends.cuda.matmul.allow_tf32 = False
                o_ref, lse_ref = fa.flash_attention_reference(qi, ki, vi, scale)
                torch.backends.cuda.matmul.allow_tf32 = True
                o, lse = forward(qi, ki, vi, scale, mode, row["tile_keys"])
                torch.backends.cuda.matmul.allow_tf32 = False
                worst_o = max(worst_o, ((o - o_ref).abs().max() / o_ref.abs().max()).item())
                worst_lse = max(worst_lse, (lse - lse_ref).abs().max().item())
            row[mode] = {"rel_err_o": worst_o, "max_abs_err_lse": worst_lse,
                         "within": worst_o <= chip_smoke.F32_O_RTOL
                         and worst_lse <= chip_smoke.F32_LSE_ATOL}
        print("probe", json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v
    out = ROOT / "chiprun_out" / "probe_3xtf32.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"card": chip_smoke.card_line(), "rows": rows}, indent=1))
    for mode in modes:
        print(mode, "within the f32 tolerances at",
              sum(r[mode]["within"] for r in rows), "of", len(rows), "cases", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
