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
// Two kernels, launched in this order on one stream:
// - dq: one CTA of four warps per 64 query rows of one (batch, head). It first
//   computes delta for its rows from the O and dO tiles (and writes it out for
//   the dkv kernel), then walks the 64-row K/V tiles: S = Q K^T, dP = dO V^T,
//   dS, and dQ += dS K with dS re-packed in registers as the A operand.
// - dkv: one CTA of four warps per 64 key rows. It walks the 64-row Q/dO tiles
//   (with their LSE and delta) and computes S^T = K Q^T and dP^T = V dO^T
//   directly, so P^T and dS^T come out in the accumulator layout that is the A
//   operand of dV += P^T dO and dK += dS^T Q: no round trip through shared
//   memory. dK is scaled once at the end.
//
// What bounds it on an H100. At SD1.4's 64^2 site (B*H = 8, S = 4096, d = 40)
// dq does three products (6*B*H*Sq*Sk*d = 32 GFLOP, 33 us at 989 TFLOP/s) and
// dkv four (8*B*H*Sq*Sk*d = 43 GFLOP, 43 us), against 13 MB of Q/K/V/O/dO: both
// are compute-bound. As in the forward, the exponentials weigh as much: each
// kernel takes Sq*Sk exp2 = 134 M on the SFUs, about 32 us at 16 per clock per
// SM and 1.98 GHz.
//
// What the design does about it. Nothing S x S ever leaves the SM, and all four
// (dq: three) products run on the tensor cores with mma.sync m16n8k16 (bf16 in,
// f32 accumulate). Each warp owns 16 rows of the CTA's tile and keeps them as A
// fragments in registers for the whole loop; the streamed tiles are staged in
// shared memory with cp.async, two stages deep, so the next tile's copy overlaps
// this tile's products. Operands whose contraction runs along the sequence are
// read transposed with ldmatrix.trans. The streamed 64-row tile is processed as
// two 32-row halves, which halves the live score and dP registers. The
// exponentials run in the exp2 domain with the scale folded in. The head dim is
// zero-padded in shared memory to a multiple of 16 (40 -> 48), which is exact:
// zero columns add nothing to a contraction over d, and they only feed output
// columns that are never written. Ragged Sq/Sk: rows past the end are zero-
// filled (their dS is then exactly 0: dO and delta are zero), keys past Sk are
// masked out of P in dq, and stores are guarded. All of Q, K, V, O, dO, dQ, dK
// and dV may be strided views of a (B, S, H, D) tensor: only the last dim must
// be contiguous.
//
// Not done yet (later work): wgmma, TMA, warp specialisation, exp2 emulation on
// the FMA units, one fused kernel with atomics for dQ.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;    // rows of the CTA's own tile and of each streamed tile
constexpr int kHalf = 32;     // streamed rows per inner step (two per tile)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 row padding: conflict-free fragment loads, 16-byte rows
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// Tensor order of the pointer and stride arrays of the C interface.
enum Tensor { TQ, TK, TV, TO, TDO, TDQ, TDK, TDV, kTensors };

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;        // (B*H, Sq)
  float* delta;            // (B*H, Sq), written by dq, read by dkv
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int64_t sb[kTensors];    // element strides over (batch, head, seq)
  int64_t sh[kTensors];
  int64_t ss[kTensors];
  int heads, sq, sk, d;
  float scale;
  float scale_log2;        // scale * log2(e)
};

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copies rows [row0, row0 + 64) of one (batch, head) slice into a padded smem
// tile; rows past `rows` are zero-filled. Only the d real columns are copied.
__device__ __forceinline__ void load_tile(bf16* tile, int ld, const bf16* base,
                                          int64_t row_stride, int row0, int rows, int d) {
  const int chunks = d / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBlock * chunks; c += kThreads) {
    const int r = c / chunks;
    const int col = (c - r * chunks) * 8;
    const bool valid = row0 + r < rows;
    const bf16* src = valid ? base + (int64_t)(row0 + r) * row_stride + col : base;
    cp_async_16(tile + r * ld + col, src, valid);
  }
}

// Zeroes the head-dim padding columns [d, DP) of `tiles` consecutive tiles;
// cp.async never writes them.
template <int DP>
__device__ __forceinline__ void zero_padding(bf16* tiles, int ntiles, int d) {
  constexpr int LD = DP + kPad;
  if (d >= DP) return;
  const int padc = DP - d;
  for (int i = threadIdx.x; i < ntiles * kBlock * padc; i += kThreads) {
    const int r = i / padc;
    tiles[r * LD + d + (i - r * padc)] = __float2bfloat16(0.f);
  }
}

// A fragments (16 rows x DP, row-major) of rows [row, row + 16) of a tile.
template <int KCH>
__device__ __forceinline__ void load_a(uint32_t (&f)[KCH][4], const bf16* tile, int ld, int row,
                                       int g, int t) {
  const bf16* p = tile + (row + g) * ld + 2 * t;
#pragma unroll
  for (int kc = 0; kc < KCH; ++kc) {
    f[kc][0] = lds32(p + kc * 16);
    f[kc][1] = lds32(p + 8 * ld + kc * 16);
    f[kc][2] = lds32(p + kc * 16 + 8);
    f[kc][3] = lds32(p + 8 * ld + kc * 16 + 8);
  }
}

// c[nt] = A x B^T for the 32 streamed rows [row0, row0 + 32) of `tile`:
// A is this warp's 16 rows (registers), B's rows are the streamed rows, and the
// contraction runs over the head dim (B read as a col-major operand).
template <int KCH>
__device__ __forceinline__ void product_nt(float (&c)[kHalf / 8][4], const uint32_t (&a)[KCH][4],
                                           const bf16* tile, int ld, int row0, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < kHalf / 8; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
    const bf16* b = tile + (row0 + nt * 8 + g) * ld + 2 * t;
#pragma unroll
    for (int kc = 0; kc < KCH; ++kc) mma_bf16(c[nt], a[kc], lds32(b + kc * 16), lds32(b + kc * 16 + 8));
  }
}

// acc += X Y for X (16 x 32, the accumulator layout of product_nt, re-packed
// as bf16 A fragments) and Y the streamed rows [row0, row0 + 32) of `tile`
// (32 x DP): the contraction runs over the sequence, so Y is read transposed.
template <int DT>
__device__ __forceinline__ void product_tn(float (&acc)[DT][4], const float (&x)[kHalf / 8][4],
                                           const bf16* tile, int ld, int row0, int lane) {
#pragma unroll
  for (int kc = 0; kc < kHalf / 16; ++kc) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kc][0], x[2 * kc][1]);
    a[1] = pack_bf16(x[2 * kc][2], x[2 * kc][3]);
    a[2] = pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]);
    a[3] = pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3]);
    const bf16* row = tile + (row0 + kc * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
#pragma unroll
    for (int dt = 0; dt < DT; dt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, row + dt * 8);
      mma_bf16(acc[dt], a, b[0], b[1]);
      mma_bf16(acc[dt + 1], a, b[2], b[3]);
    }
  }
}

// Stores this warp's 16 x d accumulator rows (times `mul`) as bf16.
template <int DT>
__device__ __forceinline__ void store_rows(bf16* base, int64_t row_stride, const float (&acc)[DT][4],
                                           float mul, int row, int rows, int d, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + g + 8 * r;
    if (rr >= rows) continue;
    bf16* out = base + (int64_t)rr * row_stride;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < d) {
        *reinterpret_cast<uint32_t*>(out + col) =
            pack_bf16(acc[dt][2 * r] * mul, acc[dt][2 * r + 1] * mul);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Args args) {
  constexpr int LD = DP + kPad;
  constexpr int KCH = DP / 16;
  constexpr int DT = DP / 8;
  constexpr int NT = kHalf / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kBlock * LD;
  bf16* o_s = do_s + kBlock * LD;
  bf16* kv_s = o_s + kBlock * LD;  // [stage][K|V][64][LD]
  float* delta_s = reinterpret_cast<float*>(kv_s + 4 * kBlock * LD);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const int bh = blockIdx.y;
  const int b = bh / args.heads;
  const int h = bh - b * args.heads;
  const int m0 = blockIdx.x * kBlock;
  const int d = args.d;

  const bf16* qg = args.q + b * args.sb[TQ] + h * args.sh[TQ];
  const bf16* kg = args.k + b * args.sb[TK] + h * args.sh[TK];
  const bf16* vg = args.v + b * args.sb[TV] + h * args.sh[TV];
  const bf16* og = args.o + b * args.sb[TO] + h * args.sh[TO];
  const bf16* dog = args.dout + b * args.sb[TDO] + h * args.sh[TDO];

  zero_padding<DP>(q_s, 7, d);

  const int n_tiles = (args.sk + kBlock - 1) / kBlock;
  load_tile(q_s, LD, qg, args.ss[TQ], m0, args.sq, d);
  load_tile(do_s, LD, dog, args.ss[TDO], m0, args.sq, d);
  load_tile(o_s, LD, og, args.ss[TO], m0, args.sq, d);
  load_tile(kv_s, LD, kg, args.ss[TK], 0, args.sk, d);
  load_tile(kv_s + kBlock * LD, LD, vg, args.ss[TV], 0, args.sk, d);
  cp_async_commit();

  uint32_t qf[KCH][4], dof[KCH][4];
  float dq_acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq_acc[i][j] = 0.f;
  float lse2[2], dlt[2];  // rows g and g + 8: LSE in the log2 domain, delta

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      bf16* nxt = kv_s + ((j + 1) & 1) * 2 * kBlock * LD;
      load_tile(nxt, LD, kg, args.ss[TK], (j + 1) * kBlock, args.sk, d);
      load_tile(nxt + kBlock * LD, LD, vg, args.ss[TV], (j + 1) * kBlock, args.sk, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
      // delta = rowsum(dO * O) in f32: two threads per row, odd/even column pairs
      {
        const int r = tid >> 1;
        const bf16* dor = do_s + r * LD;
        const bf16* orow = o_s + r * LD;
        float acc = 0.f;
        for (int c = (tid & 1) * 2; c < d; c += 4) {
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dor + c));
          const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + c));
          acc += x.x * y.x + x.y * y.y;
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if ((tid & 1) == 0) {
          delta_s[r] = acc;
          if (m0 + r < args.sq) args.delta[(int64_t)bh * args.sq + m0 + r] = acc;
        }
      }
      __syncthreads();
      load_a<KCH>(qf, q_s, LD, warp * 16, g, t);
      load_a<KCH>(dof, do_s, LD, warp * 16, g, t);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + warp * 16 + g + 8 * r;
        // rows past Sq: Q and dO are zero, so their dS is 0 whatever P is
        lse2[r] = row < args.sq ? args.lse[(int64_t)bh * args.sq + row] * kLog2e : 0.f;
        dlt[r] = delta_s[warp * 16 + g + 8 * r];
      }
    }

    const bf16* k_s = kv_s + (j & 1) * 2 * kBlock * LD;
    const bf16* v_s = k_s + kBlock * LD;
    const int key0 = j * kBlock;
    const bool ragged = key0 + kBlock > args.sk;

#pragma unroll
    for (int half = 0; half < kBlock / kHalf; ++half) {
      const int r0 = half * kHalf;
      float s[NT][4], dp[NT][4];
      product_nt<KCH>(s, qf, k_s, LD, r0, g, t);   // S = Q K^T
      product_nt<KCH>(dp, dof, v_s, LD, r0, g, t); // dP = dO V^T
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[nt][e] * args.scale_log2 - lse2[e >> 1]);
          if (ragged && key0 + r0 + nt * 8 + 2 * t + (e & 1) >= args.sk) p = 0.f;
          s[nt][e] = p * (dp[nt][e] - dlt[e >> 1]);  // dS
        }
      }
      product_tn<DT>(dq_acc, s, k_s, LD, r0, lane);  // dQ += dS K
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }

  store_rows<DT>(args.dq + b * args.sb[TDQ] + h * args.sh[TDQ], args.ss[TDQ], dq_acc, args.scale,
                 m0 + warp * 16, args.sq, d, g, t);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Args args) {
  constexpr int LD = DP + kPad;
  constexpr int KCH = DP / 16;
  constexpr int DT = DP / 8;
  constexpr int NT = kHalf / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kBlock * LD;
  bf16* qd_s = v_s + kBlock * LD;  // [stage][Q|dO][64][LD]
  float* ld_s = reinterpret_cast<float*>(qd_s + 4 * kBlock * LD);  // [stage][LSE|delta][64]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const int bh = blockIdx.y;
  const int b = bh / args.heads;
  const int h = bh - b * args.heads;
  const int n0 = blockIdx.x * kBlock;
  const int d = args.d;

  const bf16* qg = args.q + b * args.sb[TQ] + h * args.sh[TQ];
  const bf16* kg = args.k + b * args.sb[TK] + h * args.sh[TK];
  const bf16* vg = args.v + b * args.sb[TV] + h * args.sh[TV];
  const bf16* dog = args.dout + b * args.sb[TDO] + h * args.sh[TDO];
  const float* lseg = args.lse + (int64_t)bh * args.sq;
  const float* deltag = args.delta + (int64_t)bh * args.sq;

  zero_padding<DP>(k_s, 6, d);

  // LSE and delta of query rows [row0, row0 + 64); zero past Sq, where Q and
  // dO are zero too, so those rows add exactly nothing
  auto load_stats = [&](float* dst, int row0) {
    const int r = tid & (kBlock - 1);
    const bool valid = row0 + r < args.sq;
    const float* src = tid < kBlock ? lseg : deltag;
    cp_async_4(dst + (tid < kBlock ? 0 : kBlock) + r, valid ? src + row0 + r : src, valid);
  };

  const int n_tiles = (args.sq + kBlock - 1) / kBlock;
  load_tile(k_s, LD, kg, args.ss[TK], n0, args.sk, d);
  load_tile(v_s, LD, vg, args.ss[TV], n0, args.sk, d);
  load_tile(qd_s, LD, qg, args.ss[TQ], 0, args.sq, d);
  load_tile(qd_s + kBlock * LD, LD, dog, args.ss[TDO], 0, args.sq, d);
  load_stats(ld_s, 0);
  cp_async_commit();

  uint32_t kf[KCH][4], vf[KCH][4];
  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      const int st = (i + 1) & 1;
      bf16* nxt = qd_s + st * 2 * kBlock * LD;
      load_tile(nxt, LD, qg, args.ss[TQ], (i + 1) * kBlock, args.sq, d);
      load_tile(nxt + kBlock * LD, LD, dog, args.ss[TDO], (i + 1) * kBlock, args.sq, d);
      load_stats(ld_s + st * 2 * kBlock, (i + 1) * kBlock);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (i == 0) {
      load_a<KCH>(kf, k_s, LD, warp * 16, g, t);
      load_a<KCH>(vf, v_s, LD, warp * 16, g, t);
    }

    const bf16* q_t = qd_s + (i & 1) * 2 * kBlock * LD;
    const bf16* do_t = q_t + kBlock * LD;
    const float* lse_t = ld_s + (i & 1) * 2 * kBlock;
    const float* dl_t = lse_t + kBlock;

#pragma unroll
    for (int half = 0; half < kBlock / kHalf; ++half) {
      const int r0 = half * kHalf;
      float pt[NT][4], dst[NT][4];
      product_nt<KCH>(pt, kf, q_t, LD, r0, g, t);    // S^T = K Q^T
      product_nt<KCH>(dst, vf, do_t, LD, r0, g, t);  // dP^T = V dO^T
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = r0 + nt * 8 + 2 * t + (e & 1);  // query: the column
          const float p = exp2f(pt[nt][e] * args.scale_log2 - lse_t[qi] * kLog2e);
          pt[nt][e] = p;                           // P^T
          dst[nt][e] = p * (dst[nt][e] - dl_t[qi]);  // dS^T
        }
      }
      product_tn<DT>(dv_acc, pt, do_t, LD, r0, lane);  // dV += P^T dO
      product_tn<DT>(dk_acc, dst, q_t, LD, r0, lane);  // dK += dS^T Q
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }

  store_rows<DT>(args.dk + b * args.sb[TDK] + h * args.sh[TDK], args.ss[TDK], dk_acc, args.scale,
                 n0 + warp * 16, args.sk, d, g, t);
  store_rows<DT>(args.dv + b * args.sb[TDV] + h * args.sh[TDV], args.ss[TDV], dv_acc, 1.f,
                 n0 + warp * 16, args.sk, d, g, t);
}

template <int DP>
cudaError_t launch_dq(const Args& args, int bh, cudaStream_t stream) {
  const int smem = 7 * kBlock * (DP + kPad) * (int)sizeof(bf16) + kBlock * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((args.sq + kBlock - 1) / kBlock, bh);
  flash_bwd_dq_kernel<DP><<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const Args& args, int bh, cudaStream_t stream) {
  const int smem = 6 * kBlock * (DP + kPad) * (int)sizeof(bf16) + 4 * kBlock * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((args.sk + kBlock - 1) / kBlock, bh);
  flash_bwd_dkv_kernel<DP><<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <bool DQ_KERNEL>
int dispatch(const Args& args, int bh, cudaStream_t st) {
#define PNPI_CASE(DP) \
  case DP:            \
    return (int)(DQ_KERNEL ? launch_dq<DP>(args, bh, st) : launch_dkv<DP>(args, bh, st));
  switch ((args.d + 15) / 16 * 16) {
    PNPI_CASE(16)
    PNPI_CASE(32)
    PNPI_CASE(48)
    PNPI_CASE(64)
    PNPI_CASE(80)
    PNPI_CASE(96)
    PNPI_CASE(112)
    PNPI_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PNPI_CASE
}

int run(bool dq_kernel, void* const* ptrs, const int64_t* strides, int batch, int heads, int sq,
        int sk, int d, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 128 || d % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Args args;
  args.q = static_cast<const bf16*>(ptrs[0]);
  args.k = static_cast<const bf16*>(ptrs[1]);
  args.v = static_cast<const bf16*>(ptrs[2]);
  args.o = static_cast<const bf16*>(ptrs[3]);
  args.dout = static_cast<const bf16*>(ptrs[4]);
  args.dq = static_cast<bf16*>(ptrs[5]);
  args.dk = static_cast<bf16*>(ptrs[6]);
  args.dv = static_cast<bf16*>(ptrs[7]);
  args.lse = static_cast<const float*>(ptrs[8]);
  args.delta = static_cast<float*>(ptrs[9]);
  for (int i = 0; i < kTensors; ++i) {
    args.sb[i] = strides[3 * i];
    args.sh[i] = strides[3 * i + 1];
    args.ss[i] = strides[3 * i + 2];
  }
  args.heads = heads;
  args.sq = sq;
  args.sk = sk;
  args.d = d;
  args.scale = scale;
  args.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dq_kernel ? dispatch<true>(args, batch * heads, st)
                   : dispatch<false>(args, batch * heads, st);
}

}  // namespace

// C interface, loaded with ctypes. `ptrs` holds ten device pointers in the
// order q, k, v, o, do, dq, dk, dv (bf16), lse, delta (f32, contiguous
// (batch*heads, sq)); `strides` holds, for the first eight in that order, their
// element strides over (batch, head, seq); each last dim must be contiguous.
// The dq kernel reads q, k, v, o, do, lse and writes dq and delta; the dkv
// kernel reads q, k, v, do, lse, delta and writes dk and dv. Unused slots may
// be null. Each returns a cudaError_t (0 on success); an unsupported head dim
// returns cudaErrorInvalidValue without launching.
extern "C" int pnpi_flash_attention_bwd_dq_bf16(void* const* ptrs, const int64_t* strides,
                                                int batch, int heads, int sq, int sk, int d,
                                                float scale, void* stream) {
  return run(true, ptrs, strides, batch, heads, sq, sk, d, scale, stream);
}

extern "C" int pnpi_flash_attention_bwd_dkv_bf16(void* const* ptrs, const int64_t* strides,
                                                 int batch, int heads, int sq, int sk, int d,
                                                 float scale, void* stream) {
  return run(false, ptrs, strides, batch, heads, sq, sk, d, scale, stream);
}
