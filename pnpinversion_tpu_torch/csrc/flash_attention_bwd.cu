// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of
// O = softmax(scale * Q K^T) V, from Q, K, V, O, dO and the forward's row
// log-sum-exp LSE (natural log, f32, (B*H, Sq)).
//
// Replaces the TPU kernels pnpinversion_tpu/ops/flash_attention.py::
// _flash_bwd_dq_kernel and ::_flash_bwd_dkv_kernel (launched by _flash_bwd_rule
// through pl.pallas_call), and the plain delta = rowsum(dO * O) pass before
// them. Same function (FlashAttention-2's backward): the probabilities are
// recomputed from LSE, P = exp(scale * Q K^T - LSE); dS = P * (dO V^T - delta);
// dQ = scale * dS K, dK = scale * dS^T Q, dV = P^T dO. P and dS are cast to
// bf16 before their products, as the TPU kernels cast them to the input type;
// every product accumulates in f32 and the outputs are stored in bf16.
//
// Three kernels, launched in this order on one stream:
// - flash_bwd_prep_kernel: for each query row, delta in f32 and LSE * log2(e),
//   written to a stats buffer of 64-row tiles, (B*H, n_q, 2, 64), that reads 0
//   past Sq; and zeroes the f32 dQ accumulator (B*H, 64 * n_q, d).
// - flash_bwd_kernel: the one pass over the scores. One CTA per 64 * NC keys of
//   one (batch, head); it walks all query tiles of 64 rows.
// - flash_bwd_dq_convert_kernel: dQ = bf16(scale * accumulator) into the
//   (strided) output.
//
// What bounds it on an H100. At SD1.4's 64^2 site (B*H = 8, S = 4096, d = 40)
// the five products are 10*B*H*Sq*Sk*d = 54 GFLOP, 54 us at 989 TFLOP/s; the
// Sq*Sk = 134 M exp2 take about 32 us on the SFUs at 16 per clock per SM; the
// dQ partial sums each CTA adds into the f32 accumulator are Sk / (64 NC)
// times Sq * d floats per head: 168 MB of L2 reductions at NC = 2. The
// kernel is bound by the tensor cores and the SFUs, as long as neither waits
// for copies and the reductions stay off the critical path.
//
// What the design does about it (FA2/FA3's single pass, with the forward's
// machinery: hopper_common.cuh):
// - A producer warpgroup (setmaxnreg 24) loads the CTA's K and V once with TMA
//   and keeps a ring of 2-3 stages of (Q, dO) tiles of 64 query rows in
//   flight, with their LSE and delta rows (one bulk copy); full/empty
//   mbarriers track the ring.
// - Each of the NC consumer warpgroups owns 64 keys. Per query tile it runs
//   S^T = K Q^T and dP^T = V dO^T as wgmma from shared memory (M = keys, both
//   operands K-major), so P^T = exp2(S^T scale log2(e) - LSE log2(e)) (one
//   exp2 per score) and dS^T = P^T (dP^T - delta) come out in the A-operand
//   layout of dV += P^T dO and dK += dS^T Q (wgmma with A in registers, dO
//   and Q read MN-major).
// - dS^T is also written to shared memory as bf16 (128-byte swizzle, one row
//   per key), and dQ_tile = dS K runs as a wgmma with both operands read
//   MN-major: M = the 64 query rows, N = d, K = the CTA's 64 * NC keys. With
//   two consumer warpgroups, one of them (alternating by tile) computes it
//   over both warpgroups' keys, so each CTA adds one partial dQ per tile; a
//   named barrier between the two orders the dS writes before it, and dS is
//   double-buffered so the next tile's writes need no second barrier. The
//   warpgroup index comes through a shuffle, so ptxas sees that branch as
//   warp-uniform; otherwise it serialises every wgmma of the kernel (C7520).
// - The dQ partial goes into an f32 tile in shared memory and one TMA bulk
//   reduce-add (cp.reduce.async.bulk .add.f32) adds it to the accumulator.
//   Measured against float2 atomics (red.global.add.v2.f32) from registers,
//   in turns on an H100: 7.8% less time at 64^2 and 19% at 32^2
//   (scripts/compare_torch_flash_bwd.py). The order of the reductions
//   varies from run to run, so dQ is not bit-reproducible; dK and dV are.
// - Head dims: TMA boxes span only the real columns of each 64-column block.
//   The contractions over d run ceil(d/16) k-steps, so the 8 columns past an
//   odd multiple of 8 are zeroed once in K, V and every Q/dO stage. Products
//   with N = d run at N = 64 per column block; columns past d are never stored.
// - Ragged edges: TMA zero-fills rows past Sq and Sk. Keys past Sk are masked
//   to P = 0 explicitly (a zero K row would give P = exp(-LSE), which can
//   overflow); query rows past Sq have Q = dO = 0 and LSE = delta = 0, so
//   their dS is exactly 0, and their accumulator rows are padding that the
//   convert kernel does not store. Q, K, V, dO, dQ, dK and dV may be strided
//   views of a (B, S, H, D) tensor.
//
// Measured and dropped: issuing the next tile's S^T and dP^T before this
// tile's dV/dK/dQ, so that its exp2 overlaps them (ptxas serialises the
// wgmmas, C7515: 1.3x the time at 64^2); each consumer adding its own dQ
// partial over its 64 keys, with no barrier between the two (twice the
// reductions: 1.37x the time at 64^2). Not done: a persistent grid, TMA
// stores.

#include "hopper_common.cuh"

namespace {

constexpr int kBlockM = 64;                      // query rows per streamed Q/dO tile
constexpr int kTileBytes = kBlockM * kRowBytes;  // one column block of a Q or dO tile
constexpr int kStatsBytes = 2 * kBlockM * 4;     // LSE * log2(e) and delta of one tile

// NC consumer warpgroups of 64 keys; DK16 = ceil(d / 16) k-steps of the
// products that contract over d.
template <int NC, int DK16>
struct Config {
  static constexpr int KB = (DK16 + 3) / 4;  // 64-column blocks of the head dim: 1 or 2
  static constexpr int kKeys = 64 * NC;
  static constexpr int kThreads = 128 * (NC + 1);
  // one consumer: two CTAs per SM, 128 registers a thread at launch; two
  // consumers: 168. The producer's and consumers' counts sum to exactly that.
  static constexpr int kMinBlocks = NC == 1 ? 2 : 1;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = NC == 1 ? 232 : 240;
  static constexpr int kStages = (NC == 2 && KB == 2) ? 2 : 3;
  static constexpr int kKVBlockBytes = kKeys * kRowBytes;  // one column block of K or V
  static constexpr int kKBytes = KB * kKVBlockBytes;
  static constexpr int kQBytes = KB * kTileBytes;  // one Q (or dO) tile
  static constexpr int kStageBytes = 2 * kQBytes;
  static constexpr int kDSBytes = kKeys * kRowBytes;  // dS^T of one query tile
  static constexpr int kStageOffset = 2 * kKBytes;    // after K and V
  static constexpr int kDSOffset = kStageOffset + kStages * kStageBytes;
  static constexpr int kStatsOffset = kDSOffset + 2 * kDSBytes;
  // dQ partials go through an f32 tile per consumer and one bulk reduce-add
  static constexpr int kDQFOffset = kStatsOffset + kStages * kStatsBytes;
  static constexpr int kDQFBytes = kBlockM * 64 * KB * 4;
  static constexpr int kBarOffset = kDQFOffset + NC * kDQFBytes;
  // + 1024: the dynamic shared memory is aligned to 1024 bytes (128-byte swizzle) by hand
  static constexpr int kSmemBytes = kBarOffset + (2 * kStages + 1) * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "over the H100's 227 KB of shared memory per block");
};

struct Params {
  const float* stats;  // (B*H, n_q, 2, 64), from the prep kernel
  float* dq_acc;       // (B*H, 64 * n_q, d), zeroed by the prep kernel
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int64_t dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;  // element strides over (batch, head, seq)
  int heads, sq, sk, d;
  float scale, scale_log2;  // scale, scale * log2(e)
  MapDims mq, mk, mv, mdo;
};

// Tensor maps of q, k, v and dO, one per 64-column block of the head dim.
struct Maps {
  CUtensorMap q[2], k[2], v[2], dout[2];
};

// D(64 x 64) = A B^T over ceil(d/16) k-steps, A and B K-major 64-row tiles;
// a k-step past column 64 is in the second column block of both.
template <int DK16, int ABlockBytes>
__device__ __forceinline__ void issue_over_d(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < DK16; ++ks) {
    const uint32_t col = (ks % 4) * 32;
    wgmma_ss_n64<0, 0>(acc, smem_desc(a + (ks / 4) * ABlockBytes + col),
                       smem_desc(b + (ks / 4) * kTileBytes + col), ks > 0);
  }
}

// acc[kb] += X Y over the tile's 64 query rows: X (64 keys x 64 queries) in
// registers as bf16 A fragments, Y (queries x d) the MN-major Q or dO tile.
template <int KB>
__device__ __forceinline__ void issue_over_queries(float (&acc)[KB][32], const uint32_t (&x)[16],
                                                   uint32_t y) {
#pragma unroll
  for (int kk = 0; kk < kBlockM / 16; ++kk) {
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      wgmma_rs_n64(acc[kb], x[4 * kk], x[4 * kk + 1], x[4 * kk + 2], x[4 * kk + 3],
                   smem_desc(y + kb * kTileBytes + kk * 16 * kRowBytes));
    }
  }
}

// Adds consumer warpgroup c's dQ partial of query tile j (64 rows x d, f32,
// in the wgmma accumulator layout) into the accumulator rows of that tile:
// through the f32 tile at dqf and one bulk reduce-add issued by the
// warpgroup's first thread.
template <int KB>
__device__ __forceinline__ void add_dq(const Params& p, const float (&dq)[KB][32], int bh,
                                       int n_q, int j, uint32_t dqf, int c, int tid) {
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  // the tile's previous bulk reduce has read it (named barrier 2 + c: this warpgroup)
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = kb * 64 + 8 * jj + 2 * t;
        if (col < p.d) {
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                           dqf + ((warp * 16 + g + 8 * r) * p.d + col) * 4),
                       "f"(dq[kb][4 * jj + 2 * r]), "f"(dq[kb][4 * jj + 2 * r + 1])
                       : "memory");
        }
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
  if (tid == 0) {
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
        "cp.async.bulk.commit_group;\n" ::"l"(
            p.dq_acc + (static_cast<int64_t>(bh) * n_q + j) * kBlockM * p.d),
        "r"(dqf), "r"(kBlockM * p.d * 4)
        : "memory");
  }
}

template <int NC, int DK16>
__global__ void __launch_bounds__(Config<NC, DK16>::kThreads, Config<NC, DK16>::kMinBlocks)
flash_bwd_kernel(const __grid_constant__ Maps maps, const Params p) {
  using C = Config<NC, DK16>;
  constexpr int KB = C::KB;
  constexpr int ST = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_k = base;
  const uint32_t s_v = base + C::kKBytes;
  const uint32_t s_stage = base + C::kStageOffset;  // stage s: Q at s * kStageBytes, dO after it
  const uint32_t s_ds = base + C::kDSOffset;        // two buffers of dS^T
  const uint32_t s_stats = base + C::kStatsOffset;
  const float* stats_s = reinterpret_cast<const float*>(smem_raw + (s_stats - raw));
  const uint32_t bar_full = base + C::kBarOffset;
  const uint32_t bar_empty = bar_full + 8 * ST;
  const uint32_t bar_kv = bar_empty + 8 * ST;

  const int n_q = (p.sq + kBlockM - 1) / kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int n0 = blockIdx.x * C::kKeys;

  // TMA writes only the d real columns of each 128-byte row. Where d is an
  // odd multiple of 8, the 8 columns up to the last k-step over d are never
  // written: zero them once in K, V and the Q and dO tiles of every stage.
  if (p.d % 16 == 8) {
    const uint32_t blk = p.d / 64, chunk = (p.d % 64) / 8;
    zero_chunk(s_k + blk * C::kKVBlockBytes, C::kKeys, chunk, threadIdx.x, C::kThreads);
    zero_chunk(s_v + blk * C::kKVBlockBytes, C::kKeys, chunk, threadIdx.x, C::kThreads);
    for (int s = 0; s < 2 * ST; ++s) {
      zero_chunk(s_stage + (s / 2) * C::kStageBytes + (s % 2) * C::kQBytes + blk * kTileBytes,
                 kBlockM, chunk, threadIdx.x, C::kThreads);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * NC);  // lane 0 of every consumer warp
    }
    mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, through a shuffle so that ptxas knows it is
  // warp-uniform: a wgmma on a path it thinks divergent is serialised
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: one thread loads K and V, then keeps the ring of Q/dO tiles full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_kv, 2 * C::kKeys * p.d * 2);
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        tma_load(s_k + kb * C::kKVBlockBytes, &maps.k[kb], p.mk, bar_kv, kb * 64, n0, h, b);
        tma_load(s_v + kb * C::kKVBlockBytes, &maps.v[kb], p.mv, bar_kv, kb * 64, n0, h, b);
      }
      const float* stats = p.stats + static_cast<int64_t>(bh) * n_q * 2 * kBlockM;
      for (int i = 0; i < n_q; ++i) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(bar_empty + 8 * s, ((i / ST) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t q_s = s_stage + s * C::kStageBytes;
        mbar_expect_tx(full, 2 * kBlockM * p.d * 2 + kStatsBytes);
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          tma_load(q_s + kb * kTileBytes, &maps.q[kb], p.mq, full, kb * 64, i * kBlockM, h, b);
          tma_load(q_s + C::kQBytes + kb * kTileBytes, &maps.dout[kb], p.mdo, full, kb * 64,
                   i * kBlockM, h, b);
        }
        bulk_load(s_stats + s * kStatsBytes, stats + i * 2 * kBlockM, kStatsBytes, full);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const uint32_t k_wg = s_k + c * 64 * kRowBytes;  // this warpgroup's 64 keys
    const uint32_t v_wg = s_v + c * 64 * kRowBytes;
    // the thread's accumulator rows are keys key_lo and key_lo + 8
    const int key_lo = n0 + c * 64 + warp * 16 + g;
    const bool past0 = key_lo >= p.sk, past1 = key_lo + 8 >= p.sk;

    float dv[KB][32], dk[KB][32];
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
#pragma unroll
      for (int i = 0; i < 32; ++i) dv[kb][i] = dk[kb][i] = 0.f;
    float s[32], dp[32];
    uint32_t pr[16], dsr[16];  // P^T and dS^T as bf16 pairs, in A-fragment order
    const uint32_t dqf = base + C::kDQFOffset + c * C::kDQFBytes;  // this consumer's f32 dQ tile

    mbar_wait(bar_kv, 0);
    for (int i = 0; i < n_q; ++i) {
      const int st = i % ST;
      const uint32_t q_s = s_stage + st * C::kStageBytes;
      const uint32_t do_s = q_s + C::kQBytes;
      mbar_wait(bar_full + 8 * st, (i / ST) & 1);
      reg_fence(s);
      reg_fence(dp);
      wgmma_fence();
      issue_over_d<DK16, C::kKVBlockBytes>(s, k_wg, q_s);  // S^T = K Q^T
      wgmma_commit();
      issue_over_d<DK16, C::kKVBlockBytes>(dp, v_wg, do_s);  // dP^T = V dO^T
      wgmma_commit();

      // s[4j + e]: key row key_lo + 8 (e >> 1), query column 8j + 2t + (e & 1)
      const float* lse2 = stats_s + st * 2 * kBlockM;
      const float* dlt = lse2 + kBlockM;
      wgmma_wait<1>();
      reg_fence(s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = ex2(fmaf(s[4 * j + e], p.scale_log2, -((e & 1) ? l.y : l.x)));
          s[4 * j + e] = ((e >> 1) ? past1 : past0) ? 0.f : pv;
        }
      }
      wgmma_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
        }
      }
#pragma unroll
      for (int k2 = 0; k2 < 16; ++k2) {
        pr[k2] = pack_bf16(s[2 * k2], s[2 * k2 + 1]);
        dsr[k2] = pack_bf16(dp[2 * k2], dp[2 * k2 + 1]);
      }

      // dS^T into this tile's buffer: row = key, 64 query columns, swizzled
      const uint32_t ds_buf = s_ds + (i & 1) * C::kDSBytes;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t row = c * 64 + warp * 16 + g + 8 * r;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(ds_buf + row * kRowBytes +
                                                          ((j ^ (row & 7)) << 4) + 4 * t),
                       "r"(dsr[2 * j + r])
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // every consumer's dS^T is in place (and the dQ product of tile i - 1,
      // which read the other buffer, is done)
      asm volatile("bar.sync 1, %0;\n" ::"n"(NC * 128) : "memory");

      reg_fence(dv);
      reg_fence(dk);
      reg_fence(pr);
      reg_fence(dsr);
      wgmma_fence();
      issue_over_queries<KB>(dv, pr, do_s);  // dV += P^T dO
      issue_over_queries<KB>(dk, dsr, q_s);  // dK += dS^T Q
      wgmma_commit();

      // the warpgroups take turns to compute dQ_tile over the CTA's keys, with
      // the whole wgmma stage on this (warp-uniform) branch
      if (NC == 1 || i % NC == c) {
        if constexpr (KB == 2) {  // free P^T and dS^T before dQ's 64 accumulators
          wgmma_wait<0>();
          reg_fence(pr);
          reg_fence(dsr);
        }
        // dQ_tile = dS K: A = dS^T's buffer, B = K, both MN-major
        float dq[KB][32];
        reg_fence(dq);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < C::kKeys / 16; ++ks) {
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) {
            wgmma_ss_n64<1, 1>(dq[kb], smem_desc(ds_buf + ks * 16 * kRowBytes),
                               smem_desc(s_k + kb * C::kKVBlockBytes + ks * 16 * kRowBytes),
                               ks > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dq);
        reg_fence(dv);
        reg_fence(dk);
        reg_fence(pr);
        reg_fence(dsr);
        add_dq<KB>(p, dq, bh, n_q, i, dqf, c, tid);
      } else {
        wgmma_wait<0>();
        reg_fence(dv);
        reg_fence(dk);
        reg_fence(pr);
        reg_fence(dsr);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);  // this stage's Q, dO and stats are read
    }
    if (tid == 0) {  // this warpgroup's bulk reduces are complete
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }

    // epilogue: dK (scaled) and dV of the thread's two key rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key_lo + 8 * r;
      if (key >= p.sk) continue;
      __nv_bfloat16* dkrow = p.dk + b * p.dk_sb + h * p.dk_sh + static_cast<int64_t>(key) * p.dk_ss;
      __nv_bfloat16* dvrow = p.dv + b * p.dv_sb + h * p.dv_sh + static_cast<int64_t>(key) * p.dv_ss;
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = kb * 64 + 8 * j + 2 * t;
          if (col < p.d) {
            *reinterpret_cast<uint32_t*>(dkrow + col) =
                pack_bf16(dk[kb][4 * j + 2 * r] * p.scale, dk[kb][4 * j + 2 * r + 1] * p.scale);
            *reinterpret_cast<uint32_t*>(dvrow + col) =
                pack_bf16(dv[kb][4 * j + 2 * r], dv[kb][4 * j + 2 * r + 1]);
          }
        }
      }
    }
  }
}

struct PrepParams {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;  // (B*H, Sq)
  float* stats;
  float* dq_acc;
  int64_t o_sb, o_sh, o_ss, do_sb, do_sh, do_ss;
  int heads, sq, d;
};

// One CTA per 64-row query tile of one (batch, head): four threads per row
// sum dO * O over d in f32.
__global__ void __launch_bounds__(256) flash_bwd_prep_kernel(const PrepParams p) {
  const int tile = blockIdx.x;
  const int n_q = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int r = threadIdx.x / 4;
  const int part = threadIdx.x % 4;
  const int row = tile * kBlockM + r;
  float acc = 0.f;
  if (row < p.sq) {
    const __nv_bfloat16* orow = p.o + b * p.o_sb + h * p.o_sh + static_cast<int64_t>(row) * p.o_ss;
    const __nv_bfloat16* drow =
        p.dout + b * p.do_sb + h * p.do_sh + static_cast<int64_t>(row) * p.do_ss;
    for (int col = 2 * part; col < p.d; col += 8) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + col));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + col));
      acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  float* st = p.stats + (static_cast<int64_t>(bh) * n_q + tile) * 2 * kBlockM;
  if (part == 0) {
    st[r] = row < p.sq ? p.lse[static_cast<int64_t>(bh) * p.sq + row] * kLog2e : 0.f;
    st[kBlockM + r] = acc;
  }
  float4* z = reinterpret_cast<float4*>(p.dq_acc +
                                        (static_cast<int64_t>(bh) * n_q + tile) * kBlockM * p.d);
  for (int i = threadIdx.x; i < kBlockM * p.d / 4; i += blockDim.x) {
    z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

struct ConvertParams {
  const float* dq_acc;
  __nv_bfloat16* dq;
  int64_t sb, sh, ss;
  int heads, sq, d;
  float scale;
};

// One CTA per 64-row query tile of one (batch, head), 8 columns a thread.
__global__ void __launch_bounds__(256) flash_bwd_dq_convert_kernel(const ConvertParams p) {
  const int tile = blockIdx.x;
  const int n_q = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int chunks = p.d / 8;
  const float* acc = p.dq_acc + (static_cast<int64_t>(bh) * n_q + tile) * kBlockM * p.d;
  for (int i = threadIdx.x; i < kBlockM * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int col = (i - r * chunks) * 8;
    const int row = tile * kBlockM + r;
    if (row >= p.sq) continue;
    const float4 x = *reinterpret_cast<const float4*>(acc + r * p.d + col);
    const float4 y = *reinterpret_cast<const float4*>(acc + r * p.d + col + 4);
    uint4 out;
    out.x = pack_bf16(x.x * p.scale, x.y * p.scale);
    out.y = pack_bf16(x.z * p.scale, x.w * p.scale);
    out.z = pack_bf16(y.x * p.scale, y.y * p.scale);
    out.w = pack_bf16(y.z * p.scale, y.w * p.scale);
    *reinterpret_cast<uint4*>(p.dq + b * p.sb + h * p.sh + static_cast<int64_t>(row) * p.ss +
                              col) = out;
  }
}

template <int NC, int DK16>
cudaError_t launch(const Maps& maps, const Params& p, int bh, cudaStream_t stream) {
  using C = Config<NC, DK16>;
  static std::atomic<uint64_t> raised{0};
  const cudaError_t err = raise_smem_once(raised, flash_bwd_kernel<NC, DK16>, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sk + C::kKeys - 1) / C::kKeys, bh);
  flash_bwd_kernel<NC, DK16><<<grid, C::kThreads, C::kSmemBytes, stream>>>(maps, p);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_d(int dk16, const Maps& maps, const Params& p, int bh, cudaStream_t st) {
  switch (dk16) {
    case 1: return launch<NC, 1>(maps, p, bh, st);
    case 2: return launch<NC, 2>(maps, p, bh, st);
    case 3: return launch<NC, 3>(maps, p, bh, st);
    case 4: return launch<NC, 4>(maps, p, bh, st);
    case 5: return launch<NC, 5>(maps, p, bh, st);
    case 6: return launch<NC, 6>(maps, p, bh, st);
    case 7: return launch<NC, 7>(maps, p, bh, st);
    case 8: return launch<NC, 8>(maps, p, bh, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int NC>
int smem_bytes_d(int dk16) {
  switch ((dk16 + 3) / 4) {  // only the column blocks change the footprint
    case 1: return Config<NC, 4>::kSmemBytes;
    case 2: return Config<NC, 8>::kSmemBytes;
    default: return -1;
  }
}

bool takes(int batch, int heads, int sq, int d) {
  return batch > 0 && heads > 0 && sq > 0 && d > 0 && d <= 128 && d % 8 == 0;
}

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers, bf16 tensors
// 16-byte aligned; strides are in elements over (batch, head, seq), each last
// dim contiguous, other strides of the TMA-read tensors (q, k, v, dout)
// multiples of 8. stats is a contiguous f32 (batch*heads, n_q, 2, 64) buffer
// and dq_acc a contiguous f32 (batch*heads, 64 * n_q, d) one, n_q =
// ceil(sq / 64); lse is the forward's contiguous f32 (batch*heads, sq). Each
// returns a cudaError_t (0 on success); inputs it does not take, or tensor
// maps the driver refuses, return cudaErrorInvalidValue without launching.

// delta and LSE * log2(e) into stats, zeroes dq_acc.
extern "C" int pnpi_flash_attention_bwd_prep_bf16(const void* o, const void* dout,
                                                  const void* lse, void* stats, void* dq_acc,
                                                  int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                                  int64_t do_sb, int64_t do_sh, int64_t do_ss,
                                                  int batch, int heads, int sq, int d,
                                                  void* stream) {
  if (!takes(batch, heads, sq, d)) return (int)cudaErrorInvalidValue;
  PrepParams p{static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
               static_cast<const float*>(lse), static_cast<float*>(stats),
               static_cast<float*>(dq_acc), o_sb, o_sh, o_ss, do_sb, do_sh, do_ss, heads, sq, d};
  const dim3 grid((sq + kBlockM - 1) / kBlockM, batch * heads);
  flash_bwd_prep_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// dK, dV, and the dQ partial sums added into dq_acc. tile_keys (64 or 128)
// is the keys per CTA.
extern "C" int pnpi_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout, const void* stats,
    void* dq_acc, void* dk, void* dv, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
    int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t do_sb,
    int64_t do_sh, int64_t do_ss, int64_t dk_sb, int64_t dk_sh, int64_t dk_ss, int64_t dv_sb,
    int64_t dv_sh, int64_t dv_ss, int batch, int heads, int sq, int sk, int d, int tile_keys,
    float scale, void* stream) {
  if (!takes(batch, heads, sq, d) || sk <= 0 || (tile_keys != 64 && tile_keys != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  Maps maps;
  Params p;
  for (int kb = 0; kb < (d + 63) / 64; ++kb) {
    const int cols = d - 64 * kb < 64 ? d - 64 * kb : 64;
    if (!make_map(&maps.q[kb], &p.mq, q, q_sb, q_sh, q_ss, batch, heads, sq, d, cols, kBlockM) ||
        !make_map(&maps.dout[kb], &p.mdo, dout, do_sb, do_sh, do_ss, batch, heads, sq, d, cols,
                  kBlockM) ||
        !make_map(&maps.k[kb], &p.mk, k, k_sb, k_sh, k_ss, batch, heads, sk, d, cols,
                  tile_keys) ||
        !make_map(&maps.v[kb], &p.mv, v, v_sb, v_sh, v_ss, batch, heads, sk, d, cols,
                  tile_keys)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  p.stats = static_cast<const float*>(stats);
  p.dq_acc = static_cast<float*>(dq_acc);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dk_sb = dk_sb;
  p.dk_sh = dk_sh;
  p.dk_ss = dk_ss;
  p.dv_sb = dv_sb;
  p.dv_sh = dv_sh;
  p.dv_ss = dv_ss;
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  const int bh = batch * heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dk16 = (d + 15) / 16;
  return (int)(tile_keys == 128 ? launch_d<2>(dk16, maps, p, bh, st)
                                : launch_d<1>(dk16, maps, p, bh, st));
}

// dq = bf16(scale * dq_acc) for the sq real rows.
extern "C" int pnpi_flash_attention_bwd_dq_convert_bf16(const void* dq_acc, void* dq,
                                                        int64_t dq_sb, int64_t dq_sh,
                                                        int64_t dq_ss, int batch, int heads,
                                                        int sq, int d, float scale,
                                                        void* stream) {
  if (!takes(batch, heads, sq, d)) return (int)cudaErrorInvalidValue;
  ConvertParams p{static_cast<const float*>(dq_acc), static_cast<__nv_bfloat16*>(dq),
                  dq_sb, dq_sh, dq_ss, heads, sq, d, scale};
  const dim3 grid((sq + kBlockM - 1) / kBlockM, batch * heads);
  flash_bwd_dq_convert_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Dynamic shared memory in bytes of the main kernel's instantiation that
// takes (tile_keys, d).
extern "C" int pnpi_flash_attention_bwd_smem_bytes(int tile_keys, int d) {
  if (d <= 0 || d > 128 || (tile_keys != 64 && tile_keys != 128)) return -1;
  return tile_keys == 128 ? smem_bytes_d<2>((d + 15) / 16) : smem_bytes_d<1>((d + 15) / 16);
}
