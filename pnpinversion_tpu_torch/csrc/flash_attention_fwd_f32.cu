// Flash-attention forward in f32 for Hopper (sm_90a), on the tensor cores as
// 3xTF32: O = softmax(scale * Q K^T) V.
//
// Replaces pnpinversion_tpu/ops/flash_attention.py::_flash_kernel on f32
// inputs, which it takes in their storage type. Same function: non-causal
// attention by online softmax over key tiles, the running max, running sum
// and O in f32, O stored in f32 and the row log-sum-exp m + log(l) in f32.
//
// What bounds it on an H100. Every product keeps f32 accuracy. On the CUDA
// cores (67 TFLOP/s) the two products of the SD1.4 64^2 site (B*H = 8, S =
// 4096, d = 40: 21.5 GFLOP) take 0.32 ms. TF32 wgmma runs at 495 TFLOP/s but
// keeps 11 significant bits. 3xTF32 keeps f32's: each operand x splits into
// hi = tf32(x) and lo = x - hi, and A B = A_hi B_hi + A_hi B_lo + A_lo B_hi
// drops only A_lo B_lo, about 2^-22 of |A||B|. Three TF32 products: 0.13 ms
// at 64^2, B*H = 8, against 0.019 ms for the 63 MB that must move (the split
// copies included), so operations bound it. Besides, the Sq*Sk exponentials
// on the SFUs (~32 us there), and the hi and lo of K and V come from L2 into
// every CTA: 16 bytes per key and head-dim column, 2.6 MB per 64-row CTA at
// 64^2.
//
// What the design does about it.
// - A split pass (flash_fwd_f32_split_kernel) reads the strided K and V once
//   and writes, per (batch * head, tile of KT keys), one contiguous block:
//   K_hi, K_lo, V^T_hi, V^T_lo, each already in the layout the wgmma
//   descriptors read (8x4 core matrices of 128 contiguous bytes, no swizzle,
//   so a head dim of 40 needs no padding). V is stored transposed because
//   .tf32 wgmma reads shared memory only K-major, and PV's K dimension is the
//   keys. The main kernel then brings each stage in with one bulk copy.
// - A CTA owns 64 * NC query rows of one (batch, head): NC consumer
//   warpgroups (wgmma's M = 64 rows each) and one producer warp, whose first
//   lane keeps a two-stage ring of K/V^T tiles full (full/empty mbarriers).
//   The wrapper picks NC (1 or 2, 2 up to d = 56) by waves
//   (ops/flash_attention.py::fwd_f32_tile_rows); 128 rows load each stage
//   once for twice the rows. With NC = 1 and d <= 40 two CTAs share an SM,
//   so one's softmax runs while the other's products hold the tensor cores.
// - Each consumer warpgroup splits its own 64 Q rows into hi and lo in shared
//   memory once (Q is read once per CTA: no split pass for it). S = Q K^T is
//   three chains of m64n{KT}k8 wgmmas from shared memory, the two small terms
//   first and hi*hi last, so the large partial sums meet the fewest
//   accumulations. The online softmax runs in f32 (exp2f), P is split in
//   registers and O_tile = P V is three chains of m64n{d}k8 with A from
//   registers. P's accumulator registers are the A fragment as they stand:
//   a thread holds keys 2t and 2t+1 of each group of 8 and the A fragment
//   wants slots t and t + 4, so V^T keeps each group's keys in the order
//   0 2 4 6 1 3 5 7 (ops/flash_attention.py::F32_KEY_PERM).
// - Two-level accumulation: each tile's P V starts from zero in its own
//   registers and is added to the running O with f32 FMAs (O = O * alpha +
//   O_tile). The tensor cores' accumulation is not IEEE round-to-nearest: in
//   3xTF32 products taken with torch.matmul on an H100, PV summed over all
//   4096 keys in one product missed the f32 O by up to 2.05e-5 of max |O|
//   (past the 2e-5 tolerance), by 64-key tiles added in f32 by at most
//   5.0e-6 (scripts/probe_3xtf32_error.py).
// - Deterministic and independent of the batch: no atomics, KT depends on d
//   alone, and a row's sums run over the same tiles in the same order
//   whatever B*H or NC, so a row repeats bit for bit across calls and grids.
// - Ragged edges: the split pass zero-fills keys past Sk and the kernel
//   masks them to -inf (a zero row would give a logit of 0); Q rows past Sq
//   are zero-filled and never stored (in a (B, S, H, D) buffer they would
//   land on the next batch's rows).
// - The process's TF32 flags do not apply: the kernel keeps f32 accuracy by
//   construction.
//
// Not done (later work): overlap of one tile's softmax with the next tile's
// QK^T inside a warpgroup (the bf16 forward's schedule), the split of K and V
// inside the main kernel, a persistent grid.

#include "tf32_tiles.cuh"
#include <math.h>

namespace {

constexpr int kStages = 2;
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory

// Keys per stage: a function of the head dim alone (ops/flash_attention.py::
// fwd_f32_tile_keys); 32 past d = 88, where two 64-key stages and a 64-row Q
// tile would not fit.
constexpr int tile_keys(int d8) { return d8 <= 11 ? 64 : 32; }

// Two consumer warpgroups (128 query rows) only up to d = 56
// (ops/flash_attention.py::F32_WIDE_TILE_MAX_D): nine warps leave a thread 168
// registers, and at d = 64 ptxas spilled.
constexpr bool two_warpgroups(int d8) { return d8 <= 7; }

// Dynamic shared memory of NC consumer warpgroups at d = 8 d8: each one's Q
// hi and lo, kStages stages of K hi, K lo, V^T hi and V^T lo, the mbarriers,
// and 128 bytes to align the base by hand.
constexpr int smem_bytes(int nc, int d8) {
  return 2 * nc * 64 * 8 * d8 * 4 + kStages * 4 * tile_keys(d8) * 8 * d8 * 4 + 2 * kStages * 8 +
         128;
}

// NC consumer warpgroups, D8 = d / 8.
template <int NC, int D8>
struct Cfg {
  static constexpr int D = 8 * D8;
  static constexpr int KT = tile_keys(D8);
  static constexpr int kThreads = 128 * NC + 32;
  static constexpr int kQBytes = 64 * D * 4;    // Q hi (or lo) of one warpgroup
  static constexpr int kArrBytes = KT * D * 4;  // K hi, K lo, V^T hi or V^T lo of a stage
  static constexpr int kStageBytes = 4 * kArrBytes;
  static constexpr int kStageOffset = 2 * NC * kQBytes;
  static constexpr int kBarOffset = kStageOffset + kStages * kStageBytes;
  static constexpr int kSmemBytes = smem_bytes(NC, D8);
  static_assert(kSmemBytes <= kMaxSmem, "Q tile and stages exceed a block's shared memory");
  // two 64-row CTAs an SM where two fit (1 KB of each SM's 228 KB is reserved
  // per CTA); 128-row CTAs would have too few registers a thread
  static constexpr int kMinBlocks = NC == 1 && 2 * (kSmemBytes + 1024) <= 233472 ? 2 : 1;
};

struct SplitParams {
  const float *k, *v;
  int64_t k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float* out;  // (batch * heads, n_tiles, 4, kt * d)
  int heads, sk, d, kt, n_tiles;
};

// One CTA per (key tile, batch * head). Thread i writes the i-th 16 bytes of
// each of the tile's four arrays (coalesced): K rows are keys (kdim d); V^T
// rows are head-dim columns (kdim kt), a group of 8 keys in the order 0 2 4 6
// 1 3 5 7, so chunk kc of a row holds keys 8 (kc / 2) + (kc % 2) + 2 u.
__global__ void __launch_bounds__(256) flash_fwd_f32_split_kernel(const SplitParams p) {
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / p.heads, h = bh - b * p.heads;
  const int arr = p.kt * p.d, key0 = j * p.kt;
  float4* out =
      reinterpret_cast<float4*>(p.out + (static_cast<int64_t>(bh) * p.n_tiles + j) * 4 * arr);
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  for (int i = threadIdx.x; i < arr / 4; i += blockDim.x) {
    float4 hi, lo;
    split4(row_chunk(kb, p.k_ss, key0, p.sk, p.d, i), hi, lo);
    out[i] = hi;
    out[arr / 4 + i] = lo;
    split4(col_chunk(vb, p.v_ss, key0, p.sk, p.kt, i), hi, lo);
    out[2 * (arr / 4) + i] = hi;
    out[3 * (arr / 4) + i] = lo;
  }
}

struct FwdParams {
  const float* q;
  int64_t q_sb, q_sh, q_ss;
  const float* kv;  // the split pass's output
  float* o;
  int64_t o_sb, o_sh, o_ss;
  float* lse;  // (batch * heads, sq), contiguous
  int heads, sq, sk, n_tiles;
  float scale_log2;  // scale * log2(e)
};

template <int NC, int D8>
__global__ void __launch_bounds__(Cfg<NC, D8>::kThreads, Cfg<NC, D8>::kMinBlocks)
    flash_fwd_f32_kernel(const FwdParams p) {
  using C = Cfg<NC, D8>;
  constexpr int D = C::D, KT = C::KT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 127u) & ~127u;
  const uint32_t s_kv = base + C::kStageOffset;  // stage s at s * kStageBytes
  const uint32_t bar_full = base + C::kBarOffset;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh - b * p.heads;
  const int m0 = blockIdx.x * 64 * NC;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * NC);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NC) {
    // producer: one thread keeps the ring full, one bulk copy per stage
    if (threadIdx.x % 32 == 0) {
      const float* src = p.kv + static_cast<int64_t>(bh) * p.n_tiles * (C::kStageBytes / 4);
      for (int j = 0; j < p.n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(bar_empty + 8 * s, ((j / kStages) - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, C::kStageBytes);
        bulk_load(s_kv + s * C::kStageBytes, src + static_cast<int64_t>(j) * (C::kStageBytes / 4),
                  C::kStageBytes, bar_full + 8 * s);
      }
    }
  } else {
    const int c = warp / 4;
    const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const uint32_t q_hi = base + 2 * c * C::kQBytes, q_lo = q_hi + C::kQBytes;
    const int row0 = m0 + 64 * c;

    // this warpgroup's 64 Q rows, split into hi and lo (zero past Sq)
    const float* qb = p.q + b * p.q_sb + h * p.q_sh;
    split_rows_to_smem<D>(q_hi, q_lo, qb, p.q_ss, row0, p.sq, tid);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the wgmmas' reads
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");

    // P's hi part has registers of its own: kept in S's, ptxas serialised the
    // wgmmas for want of registers (C7511), and 32^2 ran 2.4x slower
    float o[D / 2], ot[D / 2], s[KT / 2];
    uint32_t phi[KT / 2], plo[KT / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = ot[i] = 0.f;
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) s[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // log2-domain running max, rows g and g + 8
    float l_run[2] = {0.f, 0.f};              // this thread's partial row sums

    for (int j = 0; j < p.n_tiles; ++j) {
      const int st = j % kStages;
      const uint32_t k_hi = s_kv + st * C::kStageBytes, k_lo = k_hi + C::kArrBytes;
      const uint32_t v_hi = k_lo + C::kArrBytes, v_lo = v_hi + C::kArrBytes;
      mbar_wait(bar_full + 8 * st, (j / kStages) & 1);
      reg_fence(s);
      wgmma_fence();
      mma3_ss<KT, D8>(s, q_hi, q_lo, k_hi, k_lo);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);

      // online softmax of the 64 x KT tile; s[4c + e] is row g + 8 (e >> 1),
      // key 8c + 2t + (e & 1)
      const int key0 = j * KT;
      if (key0 + KT > p.sk) {
#pragma unroll
        for (int i = 0; i < KT / 2; ++i)
          if (key0 + (i / 4) * 8 + 2 * t + (i & 1) >= p.sk) s[i] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY}, alpha[2];
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // finite: every tile holds a real key. m_run starts at -inf, so alpha = 0
        const float m_new = fmaxf(m_run[r], mx[r] * p.scale_log2);
        alpha[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float pr = exp2f(fmaf(s[i], p.scale_log2, -m_run[r]));
        l_run[r] += pr;
        split_reg(pr, phi[i], plo[i]);
      }

      reg_fence(ot);
      reg_fence(phi);
      reg_fence(plo);
      wgmma_fence();
      mma3_rs<D, KT>(ot, phi, plo, v_hi, v_lo, true);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(ot);
      reg_fence(phi);
      reg_fence(plo);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);  // the stage may be refilled
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], ot[i]);
    }

    // epilogue: full row sums across the quad, normalise, store O and LSE
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * w + g + 8 * r;
      if (row >= p.sq) continue;
      const float inv = 1.f / l_run[r];
      float* orow = p.o + b * p.o_sb + h * p.o_sh + static_cast<int64_t>(row) * p.o_ss;
#pragma unroll
      for (int cg = 0; cg < D8; ++cg) {
        *reinterpret_cast<float2*>(orow + 8 * cg + 2 * t) =
            make_float2(o[4 * cg + 2 * r] * inv, o[4 * cg + 2 * r + 1] * inv);
      }
      if (t == 0) {
        p.lse[static_cast<int64_t>(bh) * p.sq + row] = (m_run[r] + log2f(l_run[r])) * kLn2;
      }
    }
  }
}

template <int NC, int D8>
cudaError_t launch(const FwdParams& p, int bh, cudaStream_t stream) {
  using C = Cfg<NC, D8>;
  // the shared-memory limit is raised once per instantiation and device
  static std::atomic<uint64_t> raised{0};
  const cudaError_t err = raise_smem_once(raised, flash_fwd_f32_kernel<NC, D8>, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + 64 * NC - 1) / (64 * NC), bh);
  flash_fwd_f32_kernel<NC, D8><<<grid, C::kThreads, C::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D8>
cudaError_t launch_rows(int rows, const FwdParams& p, int bh, cudaStream_t st) {
  if (rows == 64) return launch<1, D8>(p, bh, st);
  if constexpr (two_warpgroups(D8)) {
    if (rows == 128) return launch<2, D8>(p, bh, st);
  }
  return cudaErrorInvalidValue;
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

cudaError_t launch_d8(int d8, int rows, const FwdParams& p, int bh, cudaStream_t st) {
  PNPI_BY_D8(launch_rows, d8, rows, p, bh, st)
}

bool takes(int batch, int heads, int s, int d) {
  return batch > 0 && heads > 0 && s > 0 && d > 0 && d <= 128 && d % 8 == 0;
}

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers to f32;
// strides are in elements over (batch, head, seq) for the (B, H, S, D) views,
// whose last dim must be contiguous, with the other strides multiples of 4
// elements and the pointers 16-byte aligned. Each returns a cudaError_t (0 on
// success); inputs it does not take return cudaErrorInvalidValue without
// launching.

// The split pass: k and v into out, a contiguous (batch * heads, ceil(sk /
// tile_keys), 4, tile_keys * d) f32 buffer (K hi, K lo, V^T hi, V^T lo of each
// key tile, in the main kernel's shared-memory layout). tile_keys must be the
// main kernel's for d.
extern "C" int pnpi_flash_attention_fwd_f32_split(const void* k, const void* v, void* out,
                                                  int64_t k_sb, int64_t k_sh, int64_t k_ss,
                                                  int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                                  int batch, int heads, int sk, int d,
                                                  int tile_keys_, void* stream) {
  if (!takes(batch, heads, sk, d) || tile_keys_ != tile_keys(d / 8)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = (sk + tile_keys_ - 1) / tile_keys_;
  const SplitParams p{static_cast<const float*>(k), static_cast<const float*>(v), k_sb, k_sh,
                      k_ss, v_sb, v_sh, v_ss, static_cast<float*>(out), heads, sk, d, tile_keys_,
                      n_tiles};
  flash_fwd_f32_split_kernel<<<dim3(n_tiles, batch * heads), 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The main kernel: O and the row LSE (a contiguous (batch * heads, sq) f32
// buffer) from q and the split pass's output kv. tile_rows (64, or 128 where
// d <= 56) is the query rows per CTA.
extern "C" int pnpi_flash_attention_fwd_f32(const void* q, const void* kv, void* o, void* lse,
                                            int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                            int64_t o_sb, int64_t o_sh, int64_t o_ss, int batch,
                                            int heads, int sq, int sk, int d, int tile_rows,
                                            float scale, void* stream) {
  if (!takes(batch, heads, sq, d) || sk <= 0) return (int)cudaErrorInvalidValue;
  const int kt = tile_keys(d / 8);
  const FwdParams p{static_cast<const float*>(q), q_sb, q_sh, q_ss,
                    static_cast<const float*>(kv), static_cast<float*>(o), o_sb, o_sh, o_ss,
                    static_cast<float*>(lse), heads, sq, sk, (sk + kt - 1) / kt,
                    scale * kLog2e};
  return (int)launch_d8(d / 8, tile_rows, p, batch * heads, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory in bytes of the main kernel's instantiation for
// (tile_rows, d), or -1 where there is none.
extern "C" int pnpi_flash_attention_fwd_f32_smem_bytes(int tile_rows, int d) {
  if (d <= 0 || d > 128 || d % 8 || (tile_rows != 64 && tile_rows != 128)) return -1;
  if (tile_rows == 128 && !two_warpgroups(d / 8)) return -1;
  return smem_bytes(tile_rows / 64, d / 8);
}
