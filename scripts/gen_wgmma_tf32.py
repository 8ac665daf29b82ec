"""Writes ``pnpinversion_tpu_torch/csrc/wgmma_tf32.cuh`` (python3
scripts/gen_wgmma_tf32.py): the TF32 ``wgmma`` instructions that the f32
flash kernels issue, one inline-asm function per width N, since an asm
statement names each of its N / 2 accumulator registers. ``ss`` reads A and B
from shared memory, ``rs`` A from four registers; both K-major (the only
layout ``.tf32`` takes), k = 8."""
from __future__ import annotations

from pathlib import Path

OUT = Path(__file__).resolve().parents[1] / "pnpinversion_tpu_torch" / "csrc" / "wgmma_tf32.cuh"
SS_WIDTHS = (8, 16, 32, 64)  # keys (or queries) per tile of S = Q K^T, dP = dO V^T
RS_WIDTHS = tuple(range(8, 129, 8))  # head dims of O += P V, dQ += dS K, ...

HEADER = """\
// TF32 wgmma (m64nNk8, f32 accumulators) for Hopper (sm_90a): the products of
// the f32 flash kernels (flash_attention_{fwd,bwd}_f32.cu). Written by
// scripts/gen_wgmma_tf32.py; edit that script, not this file.
//
// WgmmaTf32<N>::ss: D(64xN) (+)= A(64x8) B(Nx8)^T, A and B K-major in shared
// memory (descriptors). WgmmaTf32<N>::rs: the same with A from registers: per
// thread (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of its warp's
// 16 rows (g = lane / 4, t = lane % 4). scale_d == 0 overwrites D. TF32 reads
// the top 19 bits of each f32 operand.
#pragma once

#include <stdint.h>

namespace {

template <int N>
struct WgmmaTf32;
"""


def _regs(first: int, count: int) -> str:
    return ", ".join(f"%{first + i}" for i in range(count))


def _outs(count: int) -> str:
    items = [f'"+f"(d[{i}])' for i in range(count)]
    return ",\n          ".join(", ".join(items[i:i + 6]) for i in range(0, count, 6))


def _asm(n: int, a_operand: str, b_at: int, inputs: str) -> str:
    regs = n // 2
    return (f'    asm volatile(\n'
            f'        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{b_at + 1}, 0;\\n"\n'
            f'        "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "\n'
            f'        "{{{_regs(0, regs)}}}, "\n'
            f'        "{a_operand}, %{b_at}, p, 1, 1;\\n}}\\n"\n'
            f'        : {_outs(regs)}\n'
            f'        : {inputs});\n')


def _struct(n: int) -> str:
    regs = n // 2
    out = [f"template <>\nstruct WgmmaTf32<{n}> {{"]
    if n in SS_WIDTHS:
        out.append(f"  static __device__ __forceinline__ void ss(float (&d)[{regs}], uint64_t da, "
                   f"uint64_t db, int scale_d) {{")
        out.append(_asm(n, f"%{regs}", regs + 1, '"l"(da), "l"(db), "r"(scale_d)').rstrip())
        out.append("  }")
    out.append(f"  static __device__ __forceinline__ void rs(float (&d)[{regs}], uint32_t a0, "
               f"uint32_t a1, uint32_t a2,\n"
               f"                                            uint32_t a3, uint64_t db, "
               f"int scale_d) {{")
    out.append(_asm(n, "{" + _regs(regs, 4) + "}", regs + 4,
                    '"r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d)').rstrip())
    out.append("  }\n};\n")
    return "\n".join(out)


def main() -> None:
    text = HEADER + "\n" + "\n".join(_struct(n) for n in RS_WIDTHS) + "\n}  // namespace\n"
    OUT.write_text(text)
    print(f"wrote {OUT} ({len(text.splitlines())} lines)")


if __name__ == "__main__":
    main()
