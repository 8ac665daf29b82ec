"""How far 3xTF32 products on the tensor cores land from the f32 attention
backward (python3 scripts/probe_3xtf32_bwd_error.py), before a 3xTF32
backward kernel is trusted with ``chip_smoke.F32_BWD_RTOL`` (dQ, dK and dV
within 1e-4 of max |plain|).

At every f32 backward case of ``chip_smoke.FLASH_BWD_CASES`` the backward is
taken from the plain forward's LSE and delta = rowsum(dO * O), each product
with ``torch.matmul`` and TF32 on (cuBLAS on the tensor cores), the operands
split with ``flash_attention.tf32_split``. Three ways of doing so are held
against the plain backward with TF32 off:

- ``one_tf32``: one TF32 product each for S = QK^T, dP = dO V^T, dQ = dS K,
  dK = dS^T Q and dV = P^T dO (what plain TF32 gives);
- ``three_tf32``: 3xTF32 for every product (hi lo + lo hi + hi hi), dQ summed
  over all keys and dK/dV over all queries in one product each (the
  accumulator carries every term);
- ``three_tf32_tiled``: 3xTF32, dQ summed by tiles of
  ``bwd_f32_tile_keys(d)`` keys and dK/dV by tiles of
  ``bwd_f32_tile_queries(d)`` queries, each tile's product from zero, the
  tiles added in f32 (a two-level accumulation).

One JSON line per case and all of them in ``chiprun_out/probe_3xtf32_bwd.json``.
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


def _product(a, b, mode: str, tile: int):
    """a @ b over the contracted dim as ``mode`` says (tiles of ``tile``)."""
    if mode == "one_tf32":
        return a @ b
    if mode == "three_tf32":
        return _three(a, b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=a.dtype, device=a.device)
    for j in range(0, a.shape[-1], tile):
        out += _three(a[..., j:j + tile], b[..., j:j + tile, :])
    return out


def backward(q, k, v, do, lse, delta, scale, mode: str):
    """(dQ, dK, dV) with the products taken as ``mode`` says."""
    d = q.shape[-1]
    mul = (lambda a, b: a @ b) if mode == "one_tf32" else _three
    p = torch.exp(mul(q, k.transpose(-1, -2)) * scale - lse[..., None])
    ds = p * (mul(do, v.transpose(-1, -2)) - delta[..., None])
    kt, qt = fa.bwd_f32_tile_keys(d), fa.bwd_f32_tile_queries(d)
    dq = _product(ds, k, mode, kt) * scale
    dk = _product(ds.transpose(-1, -2), q, mode, qt) * scale
    dv = _product(p.transpose(-1, -2), do, mode, qt)
    return dq, dk, dv


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_3xtf32_bwd_error: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    modes = ("one_tf32", "three_tf32", "three_tf32_tiled")
    rows = []
    for name, b, h, sq, sk, d, strided, _, dtype in chip_smoke.FLASH_BWD_CASES:
        if dtype != "f32":
            continue
        q, k, v, do = (chip_smoke._heads(gen, b, h, s, d, strided, torch.float32)
                       for s in (sq, sk, sk, sq))
        scale = d ** -0.5
        row = {"case": name, "shape": [b, h, sq, sk, d],
               "tile_keys": fa.bwd_f32_tile_keys(d), "tile_queries": fa.bwd_f32_tile_queries(d)}
        worst = {m: {"dq": 0.0, "dk": 0.0, "dv": 0.0} for m in modes}
        for i in range(b):  # one batch row (8 heads) at a time bounds the memory
            qi, ki, vi, doi = q[i:i + 1], k[i:i + 1], v[i:i + 1], do[i:i + 1]
            torch.backends.cuda.matmul.allow_tf32 = False
            out, lse = fa.flash_attention_reference(qi, ki, vi, scale)
            delta = (doi * out).sum(-1)
            want = fa.flash_attention_bwd_reference(qi, ki, vi, out, lse, doi, scale)
            for mode in modes:
                torch.backends.cuda.matmul.allow_tf32 = True
                got = backward(qi, ki, vi, doi, lse, delta, scale, mode)
                torch.backends.cuda.matmul.allow_tf32 = False
                for key, g, w in zip(("dq", "dk", "dv"), got, want):
                    worst[mode][key] = max(worst[mode][key], chip_smoke._rel(g, w))
                del got
            del out, lse, delta, want
        for mode in modes:
            row[mode] = {**{f"rel_err_{k_}": v_ for k_, v_ in worst[mode].items()},
                         "within": max(worst[mode].values()) <= chip_smoke.F32_BWD_RTOL}
        print("probe", json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, do
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out" / "probe_3xtf32_bwd.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"card": chip_smoke.card_line(), "rows": rows}, indent=1))
    for mode in modes:
        worst = max(max(r[mode][f"rel_err_{k_}"] for k_ in ("dq", "dk", "dv")) for r in rows)
        print(mode, "within F32_BWD_RTOL at", sum(r[mode]["within"] for r in rows), "of",
              len(rows), "cases; worst", worst, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
