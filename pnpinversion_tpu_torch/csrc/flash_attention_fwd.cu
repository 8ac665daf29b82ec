// Flash-attention forward for Hopper (sm_90a): O = softmax(scale * Q K^T) V.
//
// Replaces the TPU kernel pnpinversion_tpu/ops/flash_attention.py::_flash_kernel
// (launched by _flash_forward through pl.pallas_call). Same function: non-causal
// attention by online softmax over key tiles, with the running max, running sum
// and output accumulator in f32, the probabilities cast to bf16 before the PV
// product, O written in the input type and the row log-sum-exp m + log(l) in f32.
//
// What bounds it on an H100. SD1.4's main-path sites are seq 4096 / d=40 and
// seq 1024 / d=80 with 8 heads. At B*H=8, S=4096, d=40 the two products are
// 4*8*4096^2*40 = 21 GFLOP against 10 MB of Q/K/V/O: about 22 us at the
// 989 TFLOP/s bf16 tensor-core rate. With a head dim this small the
// exponentials weigh as much: 8*4096^2 = 134 M exp2 at the SFU rate of 16 per
// clock per SM take about 32 us at 1.98 GHz, more than the tensor-core floor.
// So the tensor cores and the SFUs must run at the same time, and neither may
// wait for copies or for the issue of address arithmetic.
//
// What the design does about it (warp specialisation, as on Hopper's GEMMs):
// - A CTA owns 64 * NC query rows of one (batch, head): NC consumer warpgroups
//   of 64 rows (wgmma's M) and one producer warpgroup. The wrapper picks NC
//   (1 or 2) by shape (ops/flash_attention.py::fwd_tile_rows).
// - The producer's one thread loads Q once and K/V tiles of 128 keys with TMA
//   into a ring of shared-memory stages; full/empty mbarriers track the ring,
//   so there is no __syncthreads() after set-up. setmaxnreg moves the
//   producer's registers to the consumers.
// - Each consumer computes S = Q K^T with wgmma from shared memory (Q and K
//   K-major, 128-byte swizzle) and O += P V with P in registers (the score
//   accumulator re-packed as bf16 A fragments) and V read MN-major from shared
//   memory. Tile j's QK^T is issued before tile j-1's PV, and the softmax of
//   tile j runs while PV of tile j-1 is still on the tensor cores
//   (wgmma.wait_group 1), so the exponentials overlap the products. The two
//   consumer warpgroups take turns to issue their products (named barriers),
//   so one's softmax runs while the other's products hold the tensor cores.
// - Head dims below 64 (and 80 = 64 + 16) do not fill a 128-byte swizzled row.
//   Each TMA box spans only the real columns (at most 64 per column block);
//   TMA lays it out at the swizzled 128-byte row pitch and leaves the rest of
//   the row as it was, so shared memory takes no zero padding per tile. QK^T
//   runs ceil(d/16) k-steps; the 8 columns up to that (d = 40: 40..47) are
//   zeroed once, so they leave the logits unchanged. PV runs at N = 64 per
//   column block; the columns past d only feed O columns that are never
//   stored.
// - Ragged edges: TMA zero-fills rows past Sq and Sk. Keys past Sk are masked
//   to -inf (a zero row would give a logit of 0); rows past Sq are not stored,
//   which matters because in a (B, S, H, D) buffer they would land on the
//   next batch's rows. Q/K/V/O may be strided views of a (B, S, H, D) tensor:
//   only the last dim must be contiguous, other strides multiples of 8 elements.
//
// Not done (later work): exp2 partly on the FMA units, a persistent grid,
// split-K over keys for the small 32x32 grids, TMA stores of O.

#include "hopper_common.cuh"
#include <math.h>

namespace {

constexpr int kBlockN = 128;                        // keys per K/V tile
constexpr int kKVBlockBytes = kBlockN * kRowBytes;  // one column block of a K or V tile

// NC consumer warpgroups; DK16 = ceil(d / 16) k-steps of the QK^T product.
template <int NC, int DK16>
struct Config {
  static constexpr int KB = (DK16 + 3) / 4;  // 64-column blocks of the head dim: 1 or 2
  static constexpr int kThreads = 128 * (NC + 1);
  // two 1-warpgroup CTAs share an SM when they fit (d <= 64): 128 registers a thread
  static constexpr int kMinBlocks = NC == 1 ? 2 : 1;
  static constexpr int kProducerRegs = 40;
  // the CTA's registers at launch (65536 / kThreads, or half that), less the producer's
  static constexpr int kConsumerRegs = NC == 1 ? 216 : 232;
  static constexpr int kStages = (KB == 1 && NC == 2) ? 4 : 3;
  static constexpr int kQBlockBytes = NC * 64 * kRowBytes;
  static constexpr int kQBytes = KB * kQBlockBytes;
  static constexpr int kKVBytes = KB * kKVBlockBytes;  // one K (or V) tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  // + 1024: the dynamic shared memory is aligned to 1024 bytes (128-byte swizzle) by hand
  static constexpr int kSmemBytes = kBarOffset + (2 * kStages + 1) * 8 + 1024;
};

struct Params {
  __nv_bfloat16* o;
  float* lse;                // (B*H, Sq), contiguous
  int64_t o_sb, o_sh, o_ss;  // element strides of o over (batch, head, seq)
  int heads, sq, sk, d;
  float scale_log2;          // scale * log2(e)
  MapDims mq, mk, mv;
};

// Tensor maps of q, k and v, one per 64-column block of the head dim: block
// 0 spans min(d, 64) columns, block 1 (d > 64 only) the d - 64 after them.
struct Maps {
  CUtensorMap q[2], k[2], v[2];
};

// Turns of the two consumer warpgroups (NC == 2): each issues its products
// only in its turn (named barrier 1 + c, 256 threads: its own 128 and the
// other's 128 arriving), then passes the turn on, so that one warpgroup's
// softmax runs while the other's products hold the tensor cores.
template <int NC>
__device__ __forceinline__ void turn_wait(int c) {
  if constexpr (NC == 2) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
}
template <int NC>
__device__ __forceinline__ void turn_pass(int c) {
  if constexpr (NC == 2) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
}

// S = Q K^T over ceil(d/16) k-steps; a k-step past column 64 is in the
// second column block of both tiles.
template <int DK16, int QBlockBytes>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q, uint32_t k) {
#pragma unroll
  for (int ks = 0; ks < DK16; ++ks) {
    const uint32_t col = (ks % 4) * 32;
    wgmma_ss_n128(s, smem_desc(q + (ks / 4) * QBlockBytes + col),
                  smem_desc(k + (ks / 4) * kKVBlockBytes + col), ks > 0);
  }
}

// O += P V: eight k-steps of 16 keys, each over the KB column blocks of V.
template <int KB>
__device__ __forceinline__ void issue_pv(float (&o)[KB][32], const uint32_t (&p)[32],
                                         uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      wgmma_rs_n64(o[kb], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                   smem_desc(v + kb * kKVBlockBytes + kk * 16 * kRowBytes));
    }
  }
}

// Online softmax of one 64x128 score tile in the exp2 domain. The thread
// holds rows g and g+8 of its warp's 16: s[4c + e] is row g + 8 (e >> 1),
// key 8c + 2t + (e & 1). Scores become probabilities in place; alpha is the
// factor that rescales the earlier sums.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2], int key0, int sk, int t,
                                             float scale_log2) {
  if (key0 + kBlockN > sk) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (key0 + (i / 4) * 8 + 2 * t + (i & 1) >= sk) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // finite: every tile holds a real key. m_run starts at -inf, so alpha = 0
    const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
    alpha[r] = ex2(m_run[r] - m_new);
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    const float p = ex2(fmaf(s[i], scale_log2, -m_run[r]));
    s[i] = p;
    l_run[r] += p;
  }
}

template <int NC, int DK16>
__global__ void __launch_bounds__(Config<NC, DK16>::kThreads, Config<NC, DK16>::kMinBlocks)
flash_fwd_wgmma_kernel(const __grid_constant__ Maps maps, const Params p) {
  using C = Config<NC, DK16>;
  constexpr int KB = C::KB;
  constexpr int ST = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_kv = base + C::kQBytes;  // stage s: K at s * kStageBytes, V after it
  const uint32_t bar_full = base + C::kBarOffset;
  const uint32_t bar_empty = bar_full + 8 * ST;
  const uint32_t bar_q = bar_empty + 8 * ST;

  const int n_tiles = (p.sk + kBlockN - 1) / kBlockN;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int m0 = blockIdx.x * NC * 64;

  // TMA writes only the d real columns of each 128-byte row. Where d is an
  // odd multiple of 8, the 8 columns up to the last QK^T k-step are never
  // written: zero them once, in Q and in every K stage. V's columns past d
  // stay as they are; they only feed O columns that are never stored.
  if (p.d % 16 == 8) {
    const uint32_t block = p.d / 64, chunk = (p.d % 64) / 8;
    for (int r = threadIdx.x; r < NC * 64 + ST * kBlockN; r += C::kThreads) {
      const uint32_t tile = r < NC * 64 ? s_q + block * C::kQBlockBytes
                                        : s_kv + ((r - NC * 64) / kBlockN) * C::kStageBytes +
                                              block * kKVBlockBytes;
      const uint32_t row = r < NC * 64 ? r : (r - NC * 64) % kBlockN;
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(
                       tile + row * kRowBytes + ((chunk ^ (row & 7)) << 4)),
                   "r"(0)
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  const uint32_t q_bytes = NC * 64 * p.d * 2;         // what TMA writes per Q tile
  const uint32_t stage_bytes = 2 * kBlockN * p.d * 2;  // and per K/V stage
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * NC);  // lane 0 of every consumer warp
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, q_bytes);
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        tma_load(s_q + kb * C::kQBlockBytes, &maps.q[kb], p.mq, bar_q, kb * 64, m0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(bar_empty + 8 * s, ((j / ST) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t k_s = s_kv + s * C::kStageBytes;
        mbar_expect_tx(full, stage_bytes);
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          tma_load(k_s + kb * kKVBlockBytes, &maps.k[kb], p.mk, full, kb * 64, j * kBlockN, h,
                   b);
          tma_load(k_s + C::kKVBytes + kb * kKVBlockBytes, &maps.v[kb], p.mv, full, kb * 64,
                   j * kBlockN, h, b);
        }
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
    const uint32_t q_wg = s_q + c * 64 * kRowBytes;

    float o[KB][32];
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[kb][i] = 0.f;
    float s[64];
    uint32_t pr[32];  // P as bf16 pairs, in the A-fragment order of the PV product
    float m_run[2] = {-INFINITY, -INFINITY};  // log2-domain running max, rows g and g+8
    float l_run[2] = {0.f, 0.f};              // this thread's partial row sums
    float alpha[2];

    if (c == 1) turn_pass<NC>(c);  // warpgroup 0 takes the first turn
    mbar_wait(bar_q, 0);
    mbar_wait(bar_full, 0);
    turn_wait<NC>(c);
    wgmma_fence();
    issue_qk<DK16, C::kQBlockBytes>(s, q_wg, s_kv);
    wgmma_commit();
    turn_pass<NC>(c);
    wgmma_wait<0>();
    reg_fence(s);
    softmax_tile(s, m_run, l_run, alpha, 0, p.sk, t, p.scale_log2);
#pragma unroll
    for (int i = 0; i < 32; ++i) pr[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % ST;
      const int prev = (j - 1) % ST;
      mbar_wait(bar_full + 8 * st, (j / ST) & 1);
      reg_fence(o);
      reg_fence(pr);
      turn_wait<NC>(c);
      wgmma_fence();
      issue_qk<DK16, C::kQBlockBytes>(s, q_wg, s_kv + st * C::kStageBytes);
      wgmma_commit();
      issue_pv<KB>(o, pr, s_kv + prev * C::kStageBytes + C::kKVBytes);
      wgmma_commit();
      turn_pass<NC>(c);
      wgmma_wait<1>();  // S of tile j is ready; PV of tile j-1 may still run
      reg_fence(s);
      softmax_tile(s, m_run, l_run, alpha, j * kBlockN, p.sk, t, p.scale_log2);
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(pr);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * prev);
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[kb][i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < 32; ++i) pr[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    }
    reg_fence(o);
    reg_fence(pr);
    turn_wait<NC>(c);
    wgmma_fence();
    issue_pv<KB>(o, pr, s_kv + ((n_tiles - 1) % ST) * C::kStageBytes + C::kKVBytes);
    wgmma_commit();
    if (c == 0) turn_pass<NC>(c);  // the last turn: warpgroup 0 waits for none after it
    wgmma_wait<0>();
    reg_fence(o);

    // epilogue: full row sums across the quad, normalise, store O and LSE
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + c * 64 + warp * 16 + g + 8 * r;
      if (row >= p.sq) continue;
      const float inv = 1.f / l_run[r];
      __nv_bfloat16* orow = p.o + b * p.o_sb + h * p.o_sh + static_cast<int64_t>(row) * p.o_ss;
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
        for (int ch = 0; ch < 8; ++ch) {
          const int col = kb * 64 + ch * 8 + 2 * t;
          if (col < p.d) {
            *reinterpret_cast<uint32_t*>(orow + col) =
                pack_bf16(o[kb][4 * ch + 2 * r] * inv, o[kb][4 * ch + 2 * r + 1] * inv);
          }
        }
      }
      if (t == 0) {
        p.lse[static_cast<int64_t>(bh) * p.sq + row] = (m_run[r] + log2f(l_run[r])) * kLn2;
      }
    }
  }
}

template <int NC, int DK16>
cudaError_t launch(const Maps& maps, const Params& p, int bh, cudaStream_t stream) {
  using C = Config<NC, DK16>;
  // the shared-memory limit is raised once per instantiation and device
  static std::atomic<uint64_t> raised{0};
  const cudaError_t err =
      raise_smem_once(raised, flash_fwd_wgmma_kernel<NC, DK16>, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + NC * 64 - 1) / (NC * 64), bh);
  flash_fwd_wgmma_kernel<NC, DK16><<<grid, C::kThreads, C::kSmemBytes, stream>>>(maps, p);
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

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers; strides are in
// elements over (batch, head, seq) for q/k/v/o, whose last dim must be
// contiguous, with the other strides multiples of 8 elements and the
// pointers 16-byte aligned. lse is a contiguous (batch*heads, sq) f32 buffer.
// tile_rows (64 or 128) is the query rows per CTA. Returns a cudaError_t (0 on
// success); inputs it does not take, or tensor maps the driver refuses, return
// cudaErrorInvalidValue without launching.
extern "C" int pnpi_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int batch, int heads, int sq, int sk, int d, int tile_rows, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 128 || d % 8 != 0 ||
      (tile_rows != 64 && tile_rows != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  Maps maps;
  Params p;
  for (int kb = 0; kb < (d + 63) / 64; ++kb) {
    const int cols = d - 64 * kb < 64 ? d - 64 * kb : 64;
    if (!make_map(&maps.q[kb], &p.mq, q, q_sb, q_sh, q_ss, batch, heads, sq, d, cols,
                  tile_rows) ||
        !make_map(&maps.k[kb], &p.mk, k, k_sb, k_sh, k_ss, batch, heads, sk, d, cols, kBlockN) ||
        !make_map(&maps.v[kb], &p.mv, v, v_sb, v_sh, v_ss, batch, heads, sk, d, cols, kBlockN)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_ss = o_ss;
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.scale_log2 = scale * kLog2e;
  const int bh = batch * heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dk16 = (d + 15) / 16;
  return (int)(tile_rows == 128 ? launch_d<2>(dk16, maps, p, bh, st)
                                : launch_d<1>(dk16, maps, p, bh, st));
}

// Dynamic shared memory in bytes of the instantiation that takes (tile_rows, d).
extern "C" int pnpi_flash_attention_fwd_smem_bytes(int tile_rows, int d) {
  if (d <= 0 || d > 128 || (tile_rows != 64 && tile_rows != 128)) return -1;
  return tile_rows == 128 ? smem_bytes_d<2>((d + 15) / 16) : smem_bytes_d<1>((d + 15) / 16);
}
