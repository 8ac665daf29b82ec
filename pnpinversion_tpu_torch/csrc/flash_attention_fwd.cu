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

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBlockN = 128;                        // keys per K/V tile
constexpr int kRowBytes = 128;                      // a 64-column block of bf16, one swizzle row
constexpr int kKVBlockBytes = kBlockN * kRowBytes;  // one column block of a K or V tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// Positions (1..3) of the seq, head and batch dims among a tensor map's dims,
// which the host orders by stride.
struct MapDims {
  int s, h, b;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ int map_coord(int i, MapDims m, int row, int h, int b) {
  return m.s == i ? row : (m.h == i ? h : b);
}

// One box (up to 64 columns x box rows) of a 4-d tensor map {d, ., ., .}
// into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, MapDims m,
                                         uint32_t bar, int col, int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(map_coord(1, m, row, h, b)),
      "r"(map_coord(2, m, row, h, b)), "r"(map_coord(3, m, row, h, b))
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: 8-row groups
// 1024 bytes apart. The leading offset is unused by these shapes (one swizzle
// atom along K for K-major, along N for MN-major); it is set to 1024 too.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma registers across
// the wgmma instructions that are still in flight.
template <int N>
__device__ __forceinline__ void reg_fence(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void reg_fence(float (&x)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) reg_fence(x[i]);
}

// S(64x128) (+)= A(64x16, K-major smem) * B(128x16, K-major smem)^T
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O(64x64) += P(64x16, registers) * V(16x64, MN-major smem)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// query, fetched once.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// A 4-d map {d, three of (seq, head, batch) ordered by stride} over one of
// q/k/v, with a box of `box_cols` columns by `box_rows` sequence rows,
// 128-byte swizzle, zero fill past the sequence's end. Dims of size 1 go last (their stride is
// never used; it is set to a valid one).
bool make_map(CUtensorMap* map, MapDims* dims, const void* ptr, int64_t sb, int64_t sh,
              int64_t ss, int batch, int heads, int seq, int d, int box_cols, int box_rows) {
  struct Dim {
    int64_t stride, size;
    int which;  // 0 seq, 1 head, 2 batch
  } dim[3] = {{ss, seq, 0}, {sh, heads, 1}, {sb, batch, 2}};
  auto key = [](const Dim& x) { return x.size == 1 ? INT64_MAX : x.stride; };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && key(dim[j]) < key(dim[j - 1]); --j) {
      const Dim tmp = dim[j];
      dim[j] = dim[j - 1];
      dim[j - 1] = tmp;
    }
  cuuint64_t gdim[4] = {static_cast<cuuint64_t>(d), 0, 0, 0};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  int pos[3];
  cuuint64_t extent = static_cast<cuuint64_t>(d) * 2;  // bytes spanned by the dims so far
  for (int i = 0; i < 3; ++i) {
    gdim[i + 1] = static_cast<cuuint64_t>(dim[i].size);
    gstride[i] = dim[i].size == 1 ? extent : static_cast<cuuint64_t>(dim[i].stride) * 2;
    extent = gstride[i] * gdim[i + 1];
    if (dim[i].which == 0) box[i + 1] = static_cast<cuuint32_t>(box_rows);
    pos[dim[i].which] = i + 1;
  }
  *dims = MapDims{pos[0], pos[1], pos[2]};
  const EncodeTiled encode = encode_tiled();
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), gdim, gstride,
                box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC, int DK16>
cudaError_t launch(const Maps& maps, const Params& p, int bh, cudaStream_t stream) {
  using C = Config<NC, DK16>;
  // the shared-memory limit is raised once per instantiation and device
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<NC, DK16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return err;
    raised.fetch_or(bit);
  }
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
