// Flash attention in f32 for Hopper (sm_90a): the two halves of the backward,
// on the CUDA cores, for the pipelines that run in f32 (the f32 forward is
// flash_attention_fwd_f32.cu).
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
// What bounds them on an H100. Every product keeps f32 precision, so they run
// as FMAs on the CUDA cores: 67 TFLOP/s, against 495 for TF32 wgmma, which
// keeps about three decimal digits and would miss the f32 tolerance. At the
// SD1.4 sites (B*H = 8, S = 4096, d = 40) dQ's three products (32 GFLOP) take
// 0.48 ms at that peak, against 0.01 ms to move its 26 MB: operations bound
// them, with the Sq*Sk exponentials on the SFUs besides.
//
// What the design does about it. It is the simple, right one: no tensor
// cores, no atomics, so both backward kernels give the same bits every run.
// - A CTA owns 64 rows (queries in dQ, keys in dK/dV) of one
//   (batch, head) and walks every tile of 64 of the other side. 256 threads:
//   four per row, each taking 16 of the tile's 64 columns of the scores
//   (columns t, t+4, ...), so a row's statistics reduce over four lanes of a
//   warp with two shuffles.
// - Tiles of f32 rows sit in shared memory at a pitch of d + 4 floats (d % 8
//   == 0 makes the pitch an odd number of 16-byte units), so the 16-byte
//   reads of neighbouring rows fall in different banks. The next tile is
//   copied with cp.async while the current one is used (two stages).
// - Scores: a thread reads its own row 4 floats at a time, once per 4
//   columns of d, and the same 4 floats of its 16 other rows, 4 FMAs per
//   16-byte read; the 8 rows of a warp read the same other rows (a broadcast).
// - The products over the tile (P V, dS K, P^T dO, dS^T Q) give each thread
//   a quarter of the row's d columns in registers (16-byte chunks t, t+4,
//   ...), so at d = 128 a thread holds 32 accumulators of a row, not 128; the
//   scores it needs from the other three threads of its row come by shuffle.
// - Ragged edges: rows past the sequence are zero-filled by cp.async; keys
//   past Sk get probability 0, rows past Sq are not stored.
//
// Not done (later work): 3xTF32 wgmma, as the f32 forward runs its products
// (TF32 alone misses f32's tolerance), larger tiles per thread.

#include "hopper_common.cuh"
#include <math.h>

namespace {

constexpr int kRows = 64;                // rows a CTA owns
constexpr int kTile = 64;                // rows of a tile of the other side
constexpr int kTPR = 4;                  // threads per row
constexpr int kThreads = kRows * kTPR;   // 256
constexpr int kPer = kTile / kTPR;       // tile rows each thread scores: 16

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + 64) of a (seq, d) slice with row stride `stride` into a
// tile of pitch d + 4; rows at or past `rows` are zero-filled.
__device__ __forceinline__ void load_tile(float* tile, const float* base, int64_t stride,
                                          int row0, int rows, int d) {
  const int d4 = d / 4, pitch = d + 4;
  for (int i = threadIdx.x; i < kTile * d4; i += kThreads) {
    const int r = i / d4, c = i - r * d4;
    const bool valid = row0 + r < rows;
    const float* src = valid ? base + static_cast<int64_t>(row0 + r) * stride + 4 * c : base;
    cp_async16(tile + r * pitch + 4 * c, src, valid);
  }
}

// 64 floats of a contiguous row vector from `first` on, zero past `n`.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int first, int n) {
  if (threadIdx.x < kTile) {
    const int i = first + threadIdx.x;
    cp_async4(dst + threadIdx.x, i < n ? src + i : src, i < n);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// s[i] += own . tile[4 i + t] and s2[i] += own2 . tile2[4 i + t]: the scores
// of this thread's 16 columns over the d4 16-byte chunks of a row.
// (The loop over the d4 chunks stays rolled: fully unrolled, ptxas hoisted
// so many loads that registers spilled, and the build took minutes.)
__device__ __forceinline__ void scores2(float (&s)[kPer], float (&s2)[kPer], const float* own,
                                        const float* tile, const float* own2, const float* tile2,
                                        int t, int d) {
  const int d4 = d / 4, pitch = d + 4;
#pragma unroll 1
  for (int c = 0; c < d4; ++c) {
    const float4 a = ld4(own + 4 * c), a2 = ld4(own2 + 4 * c);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      s[i] = dot4(a, ld4(tile + (4 * i + t) * pitch + 4 * c), s[i]);
      s2[i] = dot4(a2, ld4(tile2 + (4 * i + t) * pitch + 4 * c), s2[i]);
    }
  }
}

// acc[chunk n] += sum over the tile's 64 rows j of w_j * tile[j][chunk t + 4n],
// where w_j is w[j / 4] of lane (lane & ~3) + j % 4.
template <int NCH>
__device__ __forceinline__ void accumulate(float4 (&acc)[NCH], const float (&w)[kPer],
                                           const float* tile, int t, int d) {
  const int d4 = d / 4, pitch = d + 4, base = (threadIdx.x & 31) & ~3;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
#pragma unroll 1
    for (int u = 0; u < kTPR; ++u) {
      const float wj = __shfl_sync(0xffffffffu, w[i], base + u);
      const float* row = tile + (4 * i + u) * pitch;
#pragma unroll
      for (int n = 0; n < NCH; ++n) {
        const int c = t + 4 * n;
        if (c < d4) {
          const float4 x = ld4(row + 4 * c);
          acc[n].x = fmaf(wj, x.x, acc[n].x);
          acc[n].y = fmaf(wj, x.y, acc[n].y);
          acc[n].z = fmaf(wj, x.z, acc[n].z);
          acc[n].w = fmaf(wj, x.w, acc[n].w);
        }
      }
    }
  }
}

// Stores scale * acc as this thread's chunks of a row.
template <int NCH>
__device__ __forceinline__ void store_row(float* dst, const float4 (&acc)[NCH], float scale,
                                          int t, int d) {
  const int d4 = d / 4;
#pragma unroll
  for (int n = 0; n < NCH; ++n) {
    const int c = t + 4 * n;
    if (c < d4) {
      *reinterpret_cast<float4*>(dst + 4 * c) =
          make_float4(acc[n].x * scale, acc[n].y * scale, acc[n].z * scale, acc[n].w * scale);
    }
  }
}

template <int NCH>
__device__ __forceinline__ void zero(float4 (&acc)[NCH]) {
#pragma unroll
  for (int n = 0; n < NCH; ++n) acc[n] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Strides in elements over (batch, head, seq); the last dim is contiguous.
struct Strided {
  const float* p;
  int64_t sb, sh, ss;
  __device__ const float* at(int b, int h) const { return p + b * sb + h * sh; }
};

struct Out {
  float* p;
  int64_t sb, sh, ss;
  __device__ float* at(int b, int h) const { return p + b * sb + h * sh; }
};

struct BwdParams {
  Strided q, k, v, dout;
  const float* lse;    // (batch * heads, sq)
  const float* delta;  // (batch * heads, sq)
  Out dq, dk, dv;
  int heads, sq, sk, d;
  float scale, scale_log2;
};

// dQ: one CTA per (64 queries, batch * head); smem: Q, dO, two stages of K, V.
template <int NCH>
__global__ void __launch_bounds__(kThreads, NCH <= 3 ? 2 : 1)
    flash_bwd_dq_f32_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int pitch = p.d + 4, tile = kTile * pitch;
  float* s_q = smem;
  float* s_do = smem + tile;
  float* s_k = smem + 2 * tile;  // stage s: K at s_k + 2 s tile, V at s_k + (2 s + 1) tile
  const int bh = blockIdx.y, b = bh / p.heads, h = bh - b * p.heads;
  const int q0 = blockIdx.x * kRows, r = threadIdx.x / kTPR, t = threadIdx.x % kTPR;
  const float *kb = p.k.at(b, h), *vb = p.v.at(b, h);
  load_tile(s_q, p.q.at(b, h), p.q.ss, q0, p.sq, p.d);
  load_tile(s_do, p.dout.at(b, h), p.dout.ss, q0, p.sq, p.d);
  load_tile(s_k, kb, p.k.ss, 0, p.sk, p.d);
  load_tile(s_k + tile, vb, p.v.ss, 0, p.sk, p.d);
  cp_commit();
  const int row = q0 + r;
  const int64_t stat = static_cast<int64_t>(bh) * p.sq + row;
  const float lse2 = row < p.sq ? p.lse[stat] * kLog2e : 0.f;
  const float delta = row < p.sq ? p.delta[stat] : 0.f;

  float4 dq[NCH];
  zero(dq);
  const int n_tiles = (p.sk + kTile - 1) / kTile;
  for (int j = 0; j < n_tiles; ++j) {
    float* ks = s_k + 2 * (j & 1) * tile;
    if (j + 1 < n_tiles) {
      float* next = s_k + 2 * ((j + 1) & 1) * tile;
      load_tile(next, kb, p.k.ss, (j + 1) * kTile, p.sk, p.d);
      load_tile(next + tile, vb, p.v.ss, (j + 1) * kTile, p.sk, p.d);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float s[kPer], dp[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) s[i] = dp[i] = 0.f;
    scores2(s, dp, s_q + r * pitch, ks, s_do + r * pitch, ks + tile, t, p.d);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float pr =
          j * kTile + 4 * i + t < p.sk ? exp2f(fmaf(s[i], p.scale_log2, -lse2)) : 0.f;
      s[i] = pr * (dp[i] - delta);  // dS
    }
    accumulate<NCH>(dq, s, ks, t, p.d);
    __syncthreads();
  }
  if (row < p.sq) store_row<NCH>(p.dq.at(b, h) + row * p.dq.ss, dq, p.scale, t, p.d);
}

// dK, dV: one CTA per (64 keys, batch * head); smem: K, V, then two stages of
// Q, dO, LSE * log2(e) and delta.
template <int NCH>
__global__ void __launch_bounds__(kThreads, NCH <= 1 ? 2 : 1)
    flash_bwd_dkv_f32_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int pitch = p.d + 4, tile = kTile * pitch;
  float* s_k = smem;
  float* s_v = smem + tile;
  float* s_q = smem + 2 * tile;  // stage s: Q at s_q + 2 s tile, dO at s_q + (2 s + 1) tile
  float* stats = smem + 6 * tile;  // stage s: LSE at stats + 128 s, delta at + 64
  const int bh = blockIdx.y, b = bh / p.heads, h = bh - b * p.heads;
  const int k0 = blockIdx.x * kRows, r = threadIdx.x / kTPR, t = threadIdx.x % kTPR;
  const float *qb = p.q.at(b, h), *dob = p.dout.at(b, h);
  const float *lse = p.lse + static_cast<int64_t>(bh) * p.sq,
              *delta = p.delta + static_cast<int64_t>(bh) * p.sq;
  load_tile(s_k, p.k.at(b, h), p.k.ss, k0, p.sk, p.d);
  load_tile(s_v, p.v.at(b, h), p.v.ss, k0, p.sk, p.d);
  load_tile(s_q, qb, p.q.ss, 0, p.sq, p.d);
  load_tile(s_q + tile, dob, p.dout.ss, 0, p.sq, p.d);
  load_vec(stats, lse, 0, p.sq);
  load_vec(stats + kTile, delta, 0, p.sq);
  cp_commit();

  float4 dk[NCH], dv[NCH];
  zero(dk);
  zero(dv);
  const int n_tiles = (p.sq + kTile - 1) / kTile;
  for (int j = 0; j < n_tiles; ++j) {
    float* qs = s_q + 2 * (j & 1) * tile;
    float* st = stats + 2 * kTile * (j & 1);
    if (j + 1 < n_tiles) {
      const int first = (j + 1) * kTile;
      float* next = s_q + 2 * ((j + 1) & 1) * tile;
      float* next_st = stats + 2 * kTile * ((j + 1) & 1);
      load_tile(next, qb, p.q.ss, first, p.sq, p.d);
      load_tile(next + tile, dob, p.dout.ss, first, p.sq, p.d);
      load_vec(next_st, lse, first, p.sq);
      load_vec(next_st + kTile, delta, first, p.sq);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float s[kPer], dp[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) s[i] = dp[i] = 0.f;
    scores2(s, dp, s_k + r * pitch, qs, s_v + r * pitch, qs + tile, t, p.d);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qi = 4 * i + t;
      s[i] = j * kTile + qi < p.sq ? exp2f(fmaf(s[i], p.scale_log2, -st[qi] * kLog2e)) : 0.f;
      dp[i] = s[i] * (dp[i] - st[kTile + qi]);  // dS^T of this key
    }
    accumulate<NCH>(dv, s, qs + tile, t, p.d);
    accumulate<NCH>(dk, dp, qs, t, p.d);
    __syncthreads();
  }
  const int row = k0 + r;
  if (row < p.sk) {
    store_row<NCH>(p.dk.at(b, h) + row * p.dk.ss, dk, p.scale, t, p.d);
    store_row<NCH>(p.dv.at(b, h) + row * p.dv.ss, dv, 1.f, t, p.d);
  }
}

int dq_smem(int d) { return 6 * kTile * (d + 4) * 4; }
int dkv_smem(int d) { return 6 * kTile * (d + 4) * 4 + 4 * kTile * 4; }

// NCH = ceil(d / 16) 16-byte chunks of a row per thread; the shared-memory
// limit is raised once per instantiation and device, for its largest d.
template <int NCH>
cudaError_t launch_dq(const BwdParams& p, int bh, cudaStream_t stream) {
  static std::atomic<uint64_t> raised{0};
  cudaError_t err = raise_smem_once(raised, flash_bwd_dq_f32_kernel<NCH>, dq_smem(16 * NCH));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kRows - 1) / kRows, bh);
  flash_bwd_dq_f32_kernel<NCH><<<grid, kThreads, dq_smem(p.d), stream>>>(p);
  return cudaGetLastError();
}

template <int NCH>
cudaError_t launch_dkv(const BwdParams& p, int bh, cudaStream_t stream) {
  static std::atomic<uint64_t> raised{0};
  cudaError_t err = raise_smem_once(raised, flash_bwd_dkv_f32_kernel<NCH>, dkv_smem(16 * NCH));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sk + kRows - 1) / kRows, bh);
  flash_bwd_dkv_f32_kernel<NCH><<<grid, kThreads, dkv_smem(p.d), stream>>>(p);
  return cudaGetLastError();
}

#define PNPI_BY_CHUNKS(LAUNCH, P, BH, STREAM)       \
  switch ((P.d + 15) / 16) {                        \
    case 1: return (int)LAUNCH<1>(P, BH, STREAM);   \
    case 2: return (int)LAUNCH<2>(P, BH, STREAM);   \
    case 3: return (int)LAUNCH<3>(P, BH, STREAM);   \
    case 4: return (int)LAUNCH<4>(P, BH, STREAM);   \
    case 5: return (int)LAUNCH<5>(P, BH, STREAM);   \
    case 6: return (int)LAUNCH<6>(P, BH, STREAM);   \
    case 7: return (int)LAUNCH<7>(P, BH, STREAM);   \
    case 8: return (int)LAUNCH<8>(P, BH, STREAM);   \
    default: return (int)cudaErrorInvalidValue;     \
  }

bool takes(int batch, int heads, int sq, int sk, int d) {
  return batch > 0 && heads > 0 && sq > 0 && sk > 0 && d > 0 && d <= 128 && d % 8 == 0;
}

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers to f32;
// strides are in elements over (batch, head, seq) for the (B, H, S, D) views,
// whose last dim must be contiguous, with the other strides multiples of 4
// elements and the pointers 16-byte aligned. lse and delta are contiguous
// (batch * heads, sq) f32 buffers. Returns a cudaError_t (0 on success);
// shapes it does not take return cudaErrorInvalidValue without launching.
// dQ (dq_only != 0) or dK and dV of the backward, from the forward's LSE and
// delta = rowsum(dO * O).
extern "C" int pnpi_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, void* dk, void* dv, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t do_sb, int64_t do_sh, int64_t do_ss, int64_t dq_sb, int64_t dq_sh, int64_t dq_ss,
    int64_t dk_sb, int64_t dk_sh, int64_t dk_ss, int64_t dv_sb, int64_t dv_sh, int64_t dv_ss,
    int batch, int heads, int sq, int sk, int d, float scale, int dq_only, void* stream) {
  if (!takes(batch, heads, sq, sk, d)) return (int)cudaErrorInvalidValue;
  const BwdParams p{{static_cast<const float*>(q), q_sb, q_sh, q_ss},
                    {static_cast<const float*>(k), k_sb, k_sh, k_ss},
                    {static_cast<const float*>(v), v_sb, v_sh, v_ss},
                    {static_cast<const float*>(dout), do_sb, do_sh, do_ss},
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta),
                    {static_cast<float*>(dq), dq_sb, dq_sh, dq_ss},
                    {static_cast<float*>(dk), dk_sb, dk_sh, dk_ss},
                    {static_cast<float*>(dv), dv_sb, dv_sh, dv_ss},
                    heads, sq, sk, d, scale, scale * kLog2e};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dq_only) {
    PNPI_BY_CHUNKS(launch_dq, p, batch * heads, st)
  }
  PNPI_BY_CHUNKS(launch_dkv, p, batch * heads, st)
}
