// Flash-attention backward in f32 for Hopper (sm_90a), on the tensor cores as
// 3xTF32: the dQ kernel and the dK/dV kernel, each fed by a split pass.
//
// Replaces the TPU kernels of pnpinversion_tpu/ops/flash_attention.py on f32
// inputs, which those kernels take in their storage type:
// - flash_bwd_dq_f32_kernel: _flash_bwd_dq_kernel. dQ = scale * dS K with
//   P = exp(scale * Q K^T - LSE) recomputed and dS = P * (dO V^T - delta).
// - flash_bwd_dkv_f32_kernel: _flash_bwd_dkv_kernel. dK = scale * dS^T Q,
//   dV = P^T dO.
// delta = rowsum(dO * O) comes in from the caller, as in the JAX package,
// where it is one reduction outside Pallas (_flash_bwd_rule).
//
// What bounds them on an H100. Every product keeps f32 accuracy. As 3xTF32
// on the tensor cores (495 TFLOP/s; see flash_attention_fwd_f32.cu) dQ's
// three products are 18 B*H*Sq*Sk*d FLOPs and dK/dV's four 24: at the SD1.4
// 64^2 site (B*H = 8, S = 4096, d = 40) 0.195 and 0.260 ms, against 0.8 ms
// for the whole backward's products on the CUDA cores (67 TFLOP/s). Bytes are
// far below that (the split copies included: ~0.06 ms at 64^2), but each
// 64-row CTA streams the other side's hi and lo tiles from L2 (24 or 32
// bytes per position and head-dim column), and the Sq*Sk exponentials run on
// the SFUs.
//
// What the design does about it.
// - Two kernels, no atomics, as the JAX package has them: a row's sums run
//   over the same tiles in the same order whatever B*H or the rows per CTA,
//   so both give the same bits every run and for every batch. (One kernel
//   that adds dQ partials with a bulk reduce-add, as the bf16 backward does,
//   would save two of the seven products but add up in another order every
//   run.)
// - .tf32 wgmma reads shared memory only K-major, and a product whose K
//   dimension is a sequence (dS K, P^T dO, dS^T Q) takes its A operand from
//   the accumulator of the product before it. So a split pass
//   (flash_bwd_f32_split_kernel) writes, per (batch * head, tile of T
//   positions), one contiguous block in the layout the wgmma descriptors
//   read: for the dQ kernel K and V (rows, kdim d) and K^T (kdim T, keys in
//   F32_KEY_PERM order); for the dK/dV kernel Q and dO, Q^T and dO^T, and
//   the tile's LSE and delta. Each stage then comes in with one bulk copy.
// - A CTA owns 64 * NC rows of one (batch, head) (queries for dQ, keys for
//   dK/dV): NC consumer warpgroups and one producer warp keeping a two-stage
//   ring of the other side's tiles full. NC = 2 only where both warpgroups'
//   rows and two stages fit; the wrapper picks it by waves. Each warpgroup
//   splits its own rows (Q and dO, or K and V) into hi and lo in shared
//   memory once.
// - dQ: S = Q K^T and dP = dO V^T from shared memory (m64n{KT}k8 chains), P
//   = exp2(S scale log2(e) - LSE log2(e)), dS = P (dP - delta) split in
//   registers, dQ += dS K^T with A from registers (m64n{d}k8). dK/dV: S^T =
//   K Q^T and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q with A from
//   registers.
// - One accumulator per output across all tiles: in 3xTF32 products taken
//   with torch.matmul on an H100, dQ/dK/dV summed in one product missed the
//   f32 backward by at most 1.35e-5 of max |plain| at every f32 case of
//   chip_smoke.py (limit 1e-4), by tiles added in f32 by 3.6e-6
//   (scripts/probe_3xtf32_bwd_error.py). A second, per-tile accumulator
//   would cost d registers a thread in the dK/dV kernel.
// - Tiles of the other side by d alone (ops/flash_attention.py::
//   bwd_f32_tile_keys, bwd_f32_tile_queries): two stages and the 64-row
//   tiles fit in 227 KB up to d = 128.
// - Ragged edges: the split pass zero-fills positions past the sequence and
//   gives queries past Sq an LSE of +inf, so their P and dS are exactly 0 in
//   the dK/dV kernel; the dQ kernel sets P of keys past Sk to 0. Rows past
//   the sequence are zero-filled and never stored.
//
// Not done (later work): overlap of one tile's elementwise work with the
// next tile's products inside a warpgroup, LSE and delta folded into fewer
// passes, a persistent grid.

#include "tf32_tiles.cuh"
#include <math.h>

namespace {

constexpr int kStages = 2;
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory

// Keys per stage of the dQ kernel and queries per stage of the dK/dV kernel:
// functions of the head dim alone (ops/flash_attention.py)
constexpr int dq_tile(int d8) { return d8 <= 7 ? 64 : d8 <= 11 ? 32 : 16; }
constexpr int dkv_tile(int d8) { return d8 <= 9 ? 32 : d8 <= 14 ? 16 : 8; }

// Arrays of a split tile: K, V, K^T (dQ) or Q, dO, Q^T, dO^T (dK/dV), hi and lo
constexpr int kDqArrays = 6;
constexpr int kDkvArrays = 8;

// Bytes of one split tile (a stage): the arrays, and for the dK/dV kernel the
// tile's LSE and delta
constexpr int dq_stage_bytes(int d8) { return kDqArrays * dq_tile(d8) * 8 * d8 * 4; }
constexpr int dkv_stage_bytes(int d8) {
  return kDkvArrays * dkv_tile(d8) * 8 * d8 * 4 + 2 * dkv_tile(d8) * 4;
}

// Dynamic shared memory: each consumer warpgroup's own rows (two inputs, hi
// and lo), kStages stages, the mbarriers, 128 bytes to align the base by hand
constexpr int smem_bytes(int nc, int d8, int stage_bytes) {
  return 4 * nc * 64 * 8 * d8 * 4 + kStages * stage_bytes + 2 * kStages * 8 + 128;
}
constexpr int dq_smem(int nc, int d8) { return smem_bytes(nc, d8, dq_stage_bytes(d8)); }
constexpr int dkv_smem(int nc, int d8) { return smem_bytes(nc, d8, dkv_stage_bytes(d8)); }

// Two consumer warpgroups (128 rows) up to d = 40 (dQ) and d = 48 (dK/dV)
// (ops/flash_attention.py::F32_BWD_WIDE_TILE_MAX_D). Nine warps leave a
// thread 168 registers: dK/dV at d = 56 spilled. Past d = 40 two warpgroups'
// Q and dO and two 64-key stages do not fit (dQ at d = 64 would at 32 keys a
// stage).
constexpr bool dq_two_warpgroups(int d8) { return d8 <= 5; }
constexpr bool dkv_two_warpgroups(int d8) { return d8 <= 6; }

template <int NC, int D8, bool DKV>
struct Cfg {
  static constexpr int D = 8 * D8;
  static constexpr int T = DKV ? dkv_tile(D8) : dq_tile(D8);
  static constexpr int kThreads = 128 * NC + 32;
  static constexpr int kRowBytes = 64 * D * 4;  // one hi (or lo) of a warpgroup's rows
  static constexpr int kArrBytes = T * D * 4;   // one array of a stage
  static constexpr int kStageBytes = DKV ? dkv_stage_bytes(D8) : dq_stage_bytes(D8);
  static constexpr int kStageOffset = 4 * NC * kRowBytes;
  static constexpr int kBarOffset = kStageOffset + kStages * kStageBytes;
  static constexpr int kSmemBytes = DKV ? dkv_smem(NC, D8) : dq_smem(NC, D8);
  static_assert(kSmemBytes <= kMaxSmem, "rows and stages exceed a block's shared memory");
  static_assert(kStageBytes % 16 == 0, "a bulk copy moves multiples of 16 bytes");
  // two 64-row CTAs an SM where two fit (1 KB of each SM's 228 KB is reserved
  // per CTA)
  static constexpr int kMinBlocks = NC == 1 && 2 * (kSmemBytes + 1024) <= 233472 ? 2 : 1;
};

struct SplitParams {
  const float *x, *y;
  int64_t x_sb, x_sh, x_ss, y_sb, y_sh, y_ss;
  const float *lse, *delta;  // (batch * heads, s), contiguous; null for the dQ kernel's split
  float* out;                // (batch * heads, n_tiles, stage floats)
  int heads, s, d, t, n_tiles;
};

// One CTA per (tile, batch * head). Thread i writes the i-th 16 bytes of each
// array of the tile: X hi, X lo, Y hi, Y lo (rows, kdim d), X^T hi, X^T lo
// (kdim t, F32_KEY_PERM order), and with LSE and delta given, Y^T hi, Y^T lo,
// then the tile's LSE (+inf past s) and delta (0 past s).
__global__ void __launch_bounds__(256) flash_bwd_f32_split_kernel(const SplitParams p) {
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / p.heads, h = bh - b * p.heads;
  const int arr4 = p.t * p.d / 4, row0 = j * p.t;
  const bool dkv = p.lse != nullptr;
  const int64_t tile_floats = (dkv ? kDkvArrays : kDqArrays) * 4 * arr4 + (dkv ? 2 * p.t : 0);
  float* tile = p.out + (static_cast<int64_t>(bh) * p.n_tiles + j) * tile_floats;
  float4* out = reinterpret_cast<float4*>(tile);
  const float* xb = p.x + b * p.x_sb + h * p.x_sh;
  const float* yb = p.y + b * p.y_sb + h * p.y_sh;
  for (int i = threadIdx.x; i < arr4; i += blockDim.x) {
    float4 hi, lo;
    split4(row_chunk(xb, p.x_ss, row0, p.s, p.d, i), hi, lo);
    out[i] = hi;
    out[arr4 + i] = lo;
    split4(row_chunk(yb, p.y_ss, row0, p.s, p.d, i), hi, lo);
    out[2 * arr4 + i] = hi;
    out[3 * arr4 + i] = lo;
    split4(col_chunk(xb, p.x_ss, row0, p.s, p.t, i), hi, lo);
    out[4 * arr4 + i] = hi;
    out[5 * arr4 + i] = lo;
    if (dkv) {
      split4(col_chunk(yb, p.y_ss, row0, p.s, p.t, i), hi, lo);
      out[6 * arr4 + i] = hi;
      out[7 * arr4 + i] = lo;
    }
  }
  if (dkv) {
    float* stats = tile + kDkvArrays * 4 * arr4;
    const int64_t first = static_cast<int64_t>(bh) * p.s;
    for (int i = threadIdx.x; i < p.t; i += blockDim.x) {
      const bool in = row0 + i < p.s;
      stats[i] = in ? p.lse[first + row0 + i] : INFINITY;
      stats[p.t + i] = in ? p.delta[first + row0 + i] : 0.f;
    }
  }
}

struct BwdParams {
  const float *a, *b;  // the CTA's own rows: Q and dO (dQ) or K and V (dK/dV)
  int64_t a_sb, a_sh, a_ss, b_sb, b_sh, b_ss;
  const float* tiles;  // the split pass's output for the other side
  const float *lse, *delta;  // (batch * heads, sq): the dQ kernel's rows
  float *o1, *o2;            // dQ, or dK and dV
  int64_t o1_sb, o1_sh, o1_ss, o2_sb, o2_sh, o2_ss;
  int heads, rows, other, n_tiles;  // rows: this side's length; other: the tiles' side's
  float scale, scale_log2;
};

// The producer warp's first lane keeps the two-stage ring full: one bulk copy
// of a whole split tile per stage.
template <int kStageBytes>
__device__ __forceinline__ void produce(const float* src, int n_tiles, uint32_t stages,
                                        uint32_t bar_full, uint32_t bar_empty) {
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    if (j >= kStages) mbar_wait(bar_empty + 8 * s, ((j / kStages) - 1) & 1);
    mbar_expect_tx(bar_full + 8 * s, kStageBytes);
    bulk_load(stages + s * kStageBytes, src + static_cast<int64_t>(j) * (kStageBytes / 4),
              kStageBytes, bar_full + 8 * s);
  }
}

__device__ __forceinline__ void init_barriers(uint32_t bar_full, uint32_t bar_empty, int nc) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * nc);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Stores scale * acc, the 64 x D accumulator of a warpgroup, as rows
// row0 + 16 w + g (+ 8) of a strided (seq, D) slice, rows past `rows` not.
template <int D>
__device__ __forceinline__ void store_rows(float* dst, int64_t ss, const float (&acc)[D / 2],
                                           float scale, int row0, int rows, int w, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * w + g + 8 * r;
    if (row >= rows) continue;
    float* out = dst + static_cast<int64_t>(row) * ss;
#pragma unroll
    for (int cg = 0; cg < D / 8; ++cg) {
      *reinterpret_cast<float2*>(out + 8 * cg + 2 * t) =
          make_float2(acc[4 * cg + 2 * r] * scale, acc[4 * cg + 2 * r + 1] * scale);
    }
  }
}

// The dQ kernel's consumer warpgroup c: its 64 queries of one (batch, head)
// against every key tile. smem: each warpgroup's Q and dO hi/lo, two stages
// of K, V (rows) and K^T, hi and lo.
template <int NC, int D8>
__device__ __forceinline__ void consume_dq(const BwdParams& p, uint32_t base, int bh, int b, int h,
                                           int c) {
  using C = Cfg<NC, D8, false>;
  constexpr int D = C::D, KT = C::T;
  const uint32_t stages = base + C::kStageOffset;
  const uint32_t bar_full = base + C::kBarOffset, bar_empty = bar_full + 8 * kStages;
  const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const uint32_t q_hi = base + 4 * c * C::kRowBytes, q_lo = q_hi + C::kRowBytes;
  const uint32_t do_hi = q_lo + C::kRowBytes, do_lo = do_hi + C::kRowBytes;
  const int row0 = blockIdx.x * 64 * NC + 64 * c;
  split_rows_to_smem<D>(q_hi, q_lo, p.a + b * p.a_sb + h * p.a_sh, p.a_ss, row0, p.rows, tid);
  split_rows_to_smem<D>(do_hi, do_lo, p.b + b * p.b_sb + h * p.b_sh, p.b_ss, row0, p.rows, tid);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the wgmmas' reads
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");

  // LSE * log2(e) and delta of rows g and g + 8 (0 past Sq: never stored)
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * w + g + 8 * r;
    const int64_t at = static_cast<int64_t>(bh) * p.rows + row;
    lse2[r] = row < p.rows ? p.lse[at] * kLog2e : 0.f;
    dlt[r] = row < p.rows ? p.delta[at] : 0.f;
  }

  float dq[D / 2], s[KT / 2], dp[KT / 2];
  uint32_t hi[KT / 2], lo[KT / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) s[i] = dp[i] = 0.f;

  for (int j = 0; j < p.n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t k_hi = stages + st * C::kStageBytes, k_lo = k_hi + C::kArrBytes;
    const uint32_t v_hi = k_lo + C::kArrBytes, v_lo = v_hi + C::kArrBytes;
    const uint32_t kt_hi = v_lo + C::kArrBytes, kt_lo = kt_hi + C::kArrBytes;
    mbar_wait(bar_full + 8 * st, (j / kStages) & 1);
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
    mma3_ss<KT, D8>(s, q_hi, q_lo, k_hi, k_lo);
    mma3_ss<KT, D8>(dp, do_hi, do_lo, v_hi, v_lo);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);

    // s[4c + e] is row g + 8 (e >> 1), key 8c + 2t + (e & 1)
    const int key0 = j * KT;
    if (key0 + KT > p.other) {
#pragma unroll
      for (int i = 0; i < KT / 2; ++i)
        if (key0 + (i / 4) * 8 + 2 * t + (i & 1) >= p.other) s[i] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float pr = exp2f(fmaf(s[i], p.scale_log2, -lse2[r]));
      split_reg(pr * (dp[i] - dlt[r]), hi[i], lo[i]);
    }

    reg_fence(dq);
    reg_fence(hi);
    reg_fence(lo);
    wgmma_fence();
    mma3_rs<D, KT>(dq, hi, lo, kt_hi, kt_lo, false);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq);
    reg_fence(hi);
    reg_fence(lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);  // the stage may be refilled
  }
  store_rows<D>(p.o1 + b * p.o1_sb + h * p.o1_sh, p.o1_ss, dq, p.scale, row0, p.rows, w, g, t);
}


// The dK/dV kernel's consumer warpgroup c: its 64 keys of one (batch, head)
// against every query tile. smem: each warpgroup's K and V hi/lo, two stages
// of Q, dO (rows), Q^T and dO^T, hi and lo, and the tile's LSE and delta.
template <int NC, int D8>
__device__ __forceinline__ void consume_dkv(const BwdParams& p, uint32_t base, int bh, int b,
                                            int h, int c) {
  using C = Cfg<NC, D8, true>;
  constexpr int D = C::D, QT = C::T;
  const uint32_t stages = base + C::kStageOffset;
  const uint32_t bar_full = base + C::kBarOffset, bar_empty = bar_full + 8 * kStages;
  const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const uint32_t k_hi = base + 4 * c * C::kRowBytes, k_lo = k_hi + C::kRowBytes;
  const uint32_t v_hi = k_lo + C::kRowBytes, v_lo = v_hi + C::kRowBytes;
  const int row0 = blockIdx.x * 64 * NC + 64 * c;
  split_rows_to_smem<D>(k_hi, k_lo, p.a + b * p.a_sb + h * p.a_sh, p.a_ss, row0, p.rows, tid);
  split_rows_to_smem<D>(v_hi, v_lo, p.b + b * p.b_sb + h * p.b_sh, p.b_ss, row0, p.rows, tid);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the wgmmas' reads
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");

  float dk[D / 2], dv[D / 2], s[QT / 2], dp[QT / 2];
  uint32_t phi[QT / 2], plo[QT / 2], dshi[QT / 2], dslo[QT / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < QT / 2; ++i) s[i] = dp[i] = 0.f;

  for (int j = 0; j < p.n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t q_hi = stages + st * C::kStageBytes, q_lo = q_hi + C::kArrBytes;
    const uint32_t do_hi = q_lo + C::kArrBytes, do_lo = do_hi + C::kArrBytes;
    const uint32_t qt_hi = do_lo + C::kArrBytes, qt_lo = qt_hi + C::kArrBytes;
    const uint32_t dot_hi = qt_lo + C::kArrBytes, dot_lo = dot_hi + C::kArrBytes;
    const uint32_t stats = dot_lo + C::kArrBytes;  // LSE[QT], then delta[QT]
    mbar_wait(bar_full + 8 * st, (j / kStages) & 1);
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
    mma3_ss<QT, D8>(s, k_hi, k_lo, q_hi, q_lo);      // S^T: rows keys, columns queries
    mma3_ss<QT, D8>(dp, v_hi, v_lo, do_hi, do_lo);  // dP^T
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);

    // s[4c + e] is key g + 8 (e >> 1), query 8c + 2t + (e & 1) of the tile;
    // queries past Sq have LSE +inf, so P = 0 and dS = 0 * (0 - 0) = 0
#pragma unroll
    for (int cq = 0; cq < QT / 8; ++cq) {
      float2 l2, dl;
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(l2.x), "=f"(l2.y)
                   : "r"(stats + 4 * (8 * cq + 2 * t)));
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(dl.x), "=f"(dl.y)
                   : "r"(stats + 4 * (QT + 8 * cq + 2 * t)));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * cq + e;
        const float lse2 = (e & 1 ? l2.y : l2.x) * kLog2e, delta = e & 1 ? dl.y : dl.x;
        const float pr = exp2f(fmaf(s[i], p.scale_log2, -lse2));
        split_reg(pr, phi[i], plo[i]);
        split_reg(pr * (dp[i] - delta), dshi[i], dslo[i]);
      }
    }

    reg_fence(dk);
    reg_fence(dv);
    reg_fence(phi);
    reg_fence(plo);
    reg_fence(dshi);
    reg_fence(dslo);
    wgmma_fence();
    mma3_rs<D, QT>(dv, phi, plo, dot_hi, dot_lo, false);
    mma3_rs<D, QT>(dk, dshi, dslo, qt_hi, qt_lo, false);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dk);
    reg_fence(dv);
    reg_fence(phi);
    reg_fence(plo);
    reg_fence(dshi);
    reg_fence(dslo);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);  // the stage may be refilled
  }
  store_rows<D>(p.o1 + b * p.o1_sb + h * p.o1_sh, p.o1_ss, dk, p.scale, row0, p.rows, w, g, t);
  store_rows<D>(p.o2 + b * p.o2_sb + h * p.o2_sh, p.o2_ss, dv, 1.f, row0, p.rows, w, g, t);
}

// One CTA per (64 NC rows, batch * head): the mbarriers, then the producer
// warp's ring and the consumer warpgroups.
template <int NC, int D8, bool DKV>
__device__ __forceinline__ void run(const BwdParams& p) {
  using C = Cfg<NC, D8, DKV>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 127u) & ~127u;
  const uint32_t bar_full = base + C::kBarOffset, bar_empty = bar_full + 8 * kStages;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh - b * p.heads;
  const int warp = threadIdx.x / 32;
  init_barriers(bar_full, bar_empty, NC);
  if (warp == 4 * NC) {
    if (threadIdx.x % 32 == 0) {
      produce<C::kStageBytes>(p.tiles + static_cast<int64_t>(bh) * p.n_tiles * (C::kStageBytes / 4),
                              p.n_tiles, base + C::kStageOffset, bar_full, bar_empty);
    }
  } else if constexpr (DKV) {
    consume_dkv<NC, D8>(p, base, bh, b, h, warp / 4);
  } else {
    consume_dq<NC, D8>(p, base, bh, b, h, warp / 4);
  }
}

template <int NC, int D8>
__global__ void __launch_bounds__(Cfg<NC, D8, false>::kThreads, Cfg<NC, D8, false>::kMinBlocks)
    flash_bwd_dq_f32_kernel(const BwdParams p) {
  run<NC, D8, false>(p);
}

template <int NC, int D8>
__global__ void __launch_bounds__(Cfg<NC, D8, true>::kThreads, Cfg<NC, D8, true>::kMinBlocks)
    flash_bwd_dkv_f32_kernel(const BwdParams p) {
  run<NC, D8, true>(p);
}

template <int NC, int D8, bool DKV>
cudaError_t launch(const BwdParams& p, int bh, cudaStream_t stream) {
  using C = Cfg<NC, D8, DKV>;
  // the shared-memory limit is raised once per instantiation and device
  static std::atomic<uint64_t> raised{0};
  const dim3 grid((p.rows + 64 * NC - 1) / (64 * NC), bh);
  cudaError_t err;
  if constexpr (DKV) {
    err = raise_smem_once(raised, flash_bwd_dkv_f32_kernel<NC, D8>, C::kSmemBytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_f32_kernel<NC, D8><<<grid, C::kThreads, C::kSmemBytes, stream>>>(p);
  } else {
    err = raise_smem_once(raised, flash_bwd_dq_f32_kernel<NC, D8>, C::kSmemBytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_f32_kernel<NC, D8><<<grid, C::kThreads, C::kSmemBytes, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int D8, bool DKV>
cudaError_t launch_rows(int rows, const BwdParams& p, int bh, cudaStream_t st) {
  if (rows == 64) return launch<1, D8, DKV>(p, bh, st);
  if constexpr (DKV ? dkv_two_warpgroups(D8) : dq_two_warpgroups(D8)) {
    if (rows == 128) return launch<2, D8, DKV>(p, bh, st);
  }
  return cudaErrorInvalidValue;
}

template <int D8>
cudaError_t launch_dq(int rows, const BwdParams& p, int bh, cudaStream_t st) {
  return launch_rows<D8, false>(rows, p, bh, st);
}

template <int D8>
cudaError_t launch_dkv(int rows, const BwdParams& p, int bh, cudaStream_t st) {
  return launch_rows<D8, true>(rows, p, bh, st);
}

#define PNPI_BY_D8(FN, D8, ...)            \
  switch (D8) {                            \
    case 1: return FN<1>(__VA_ARGS__);     \
    case 2: return FN<2>(__VA_ARGS__);     \
    case 3: return FN<3>(__VA_ARGS__);     \
    case 4: return FN<4>(__VA_ARGS__);     \
    case 5: return FN<5>(__VA_ARGS__);     \
    case 6: return FN<6>(__VA_ARGS__);     \
    case 7: return FN<7>(__VA_ARGS__);     \
    case 8: return FN<8>(__VA_ARGS__);     \
    case 9: return FN<9>(__VA_ARGS__);     \
    case 10: return FN<10>(__VA_ARGS__);   \
    case 11: return FN<11>(__VA_ARGS__);   \
    case 12: return FN<12>(__VA_ARGS__);   \
    case 13: return FN<13>(__VA_ARGS__);   \
    case 14: return FN<14>(__VA_ARGS__);   \
    case 15: return FN<15>(__VA_ARGS__);   \
    case 16: return FN<16>(__VA_ARGS__);   \
    default: return cudaErrorInvalidValue; \
  }

cudaError_t launch_d8(bool dkv, int d8, int rows, const BwdParams& p, int bh, cudaStream_t st) {
  if (dkv) {
    PNPI_BY_D8(launch_dkv, d8, rows, p, bh, st)
  }
  PNPI_BY_D8(launch_dq, d8, rows, p, bh, st)
}

bool takes(int batch, int heads, int sq, int sk, int d) {
  return batch > 0 && heads > 0 && sq > 0 && sk > 0 && d > 0 && d <= 128 && d % 8 == 0;
}

int tile(bool dkv, int d) { return dkv ? dkv_tile(d / 8) : dq_tile(d / 8); }

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers to f32;
// strides are in elements over (batch, head, seq) for the (B, H, S, D) views,
// whose last dim must be contiguous, with the other strides multiples of 4
// elements and the pointers 16-byte aligned. lse and delta are contiguous
// (batch * heads, sq) f32 buffers. Each returns a cudaError_t (0 on success);
// inputs it does not take return cudaErrorInvalidValue without launching.

// The split pass of the dQ kernel (dkv == 0: x = K, y = V, s = Sk, lse and
// delta null; per tile K, V, K^T, each hi and lo) or of the dK/dV kernel
// (dkv != 0: x = Q, y = dO, s = Sq; per tile Q, dO, Q^T, dO^T, each hi and
// lo, then LSE and delta) into out, a contiguous (batch * heads,
// ceil(s / tile), stage floats) f32 buffer in the kernels' shared-memory
// layout. tile must be the kernel's for d.
extern "C" int pnpi_flash_attention_bwd_f32_split(const void* x, const void* y, const void* lse,
                                                  const void* delta, void* out, int64_t x_sb,
                                                  int64_t x_sh, int64_t x_ss, int64_t y_sb,
                                                  int64_t y_sh, int64_t y_ss, int batch,
                                                  int heads, int s, int d, int tile_, int dkv,
                                                  void* stream) {
  if (!takes(batch, heads, s, s, d) || tile_ != tile(dkv != 0, d) ||
      (dkv != 0) != (lse != nullptr && delta != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = (s + tile_ - 1) / tile_;
  const SplitParams p{static_cast<const float*>(x), static_cast<const float*>(y), x_sb, x_sh,
                      x_ss, y_sb, y_sh, y_ss, static_cast<const float*>(lse),
                      static_cast<const float*>(delta), static_cast<float*>(out), heads, s, d,
                      tile_, n_tiles};
  flash_bwd_f32_split_kernel<<<dim3(n_tiles, batch * heads), 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// dQ (dkv == 0: a = Q, b = dO, o1 = dQ, rows = Sq, other = Sk; tiles the
// dQ split of K and V; lse and delta the forward's) or dK and dV (dkv != 0:
// a = K, b = V, o1 = dK, o2 = dV, rows = Sk, other = Sq; tiles the dK/dV
// split of Q and dO, which carries LSE and delta). tile_rows (64, or 128
// where both warpgroups fit) is the rows per CTA.
extern "C" int pnpi_flash_attention_bwd_f32(
    const void* a, const void* b, const void* tiles, const void* lse, const void* delta, void* o1,
    void* o2, int64_t a_sb, int64_t a_sh, int64_t a_ss, int64_t b_sb, int64_t b_sh, int64_t b_ss,
    int64_t o1_sb, int64_t o1_sh, int64_t o1_ss, int64_t o2_sb, int64_t o2_sh, int64_t o2_ss,
    int batch, int heads, int rows, int other, int d, int tile_rows, float scale, int dkv,
    void* stream) {
  if (!takes(batch, heads, rows, other, d)) return (int)cudaErrorInvalidValue;
  const int t = tile(dkv != 0, d);
  const BwdParams p{static_cast<const float*>(a), static_cast<const float*>(b), a_sb, a_sh, a_ss,
                    b_sb, b_sh, b_ss, static_cast<const float*>(tiles),
                    static_cast<const float*>(lse), static_cast<const float*>(delta),
                    static_cast<float*>(o1), static_cast<float*>(o2), o1_sb, o1_sh, o1_ss, o2_sb,
                    o2_sh, o2_ss, heads, rows, other, (other + t - 1) / t, scale, scale * kLog2e};
  return (int)launch_d8(dkv != 0, d / 8, tile_rows, p, batch * heads,
                        static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory in bytes of the dQ (dkv == 0) or dK/dV kernel's
// instantiation for (tile_rows, d), or -1 where there is none.
extern "C" int pnpi_flash_attention_bwd_f32_smem_bytes(int dkv, int tile_rows, int d) {
  if (d <= 0 || d > 128 || d % 8 || (tile_rows != 64 && tile_rows != 128)) return -1;
  const int d8 = d / 8, nc = tile_rows / 64;
  if (nc == 2 && !(dkv ? dkv_two_warpgroups(d8) : dq_two_warpgroups(d8))) return -1;
  return dkv ? dkv_smem(nc, d8) : dq_smem(nc, d8);
}
