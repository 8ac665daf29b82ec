// Flash-attention forward for Hopper (sm_90a): O = softmax(scale * Q K^T) V.
//
// Replaces the TPU kernel pnpinversion_tpu/ops/flash_attention.py::_flash_kernel
// (launched by _flash_forward through pl.pallas_call). Same function: non-causal
// attention by online softmax over key tiles, with the running max, running sum
// and output accumulator in f32, the probabilities cast to bf16 before the PV
// product, O written in the input type and the row log-sum-exp m + log(l) in f32.
//
// What bounds it on an H100. SD1.4's main-path sites are seq 4096 / d=40 and
// seq 1024 / d=80 with 8 heads. At B*H=24, S=4096, d=40 the two products are
// 4*24*4096^2*40 = 64 GFLOP against 31 MB of Q/K/V/O, so it is compute-bound:
// about 65 us at the 989 TFLOP/s bf16 tensor-core rate (S=1024, d=80: 8 GFLOP,
// about 8 us). With a head dim this small the exponentials weigh as much as the
// products: 24*4096^2 = 403 M exp2 at the SFU rate of 16 per clock per SM is
// about 96 us at 1.98 GHz, more than the tensor-core floor.
//
// What the design does about it. Nothing S x S ever leaves the SM: one CTA of
// four warps owns 64 query rows of one (batch, head); each warp owns 16 rows and
// keeps its Q fragments, scores, probabilities and output accumulator in
// registers. K/V tiles of 64 rows are staged in shared memory with cp.async, two
// stages deep, so the next tile's copy overlaps this tile's products. Both
// products run on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate); the score accumulator is re-packed in registers as the A operand
// of the PV product, and V is read transposed with ldmatrix.trans. The softmax
// works in the exp2 domain (one FMUL folded into the scale). The head dim is
// zero-padded in shared memory to a multiple of 16 (40 -> 48), which is exact:
// zero Q/K columns add nothing to the logits and zero V columns only feed output
// columns that are never written. Ragged Sq/Sk are masked (-inf logits,
// zero-filled rows, guarded stores). Q/K/V/O may be strided views of a
// (B, S, H, D) tensor: only the last dim must be contiguous.
//
// Not done yet (later work): wgmma, TMA, warp specialisation, exp2 emulation on
// the FMA units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per CTA, 16 per warp
constexpr int kBlockN = 64;   // key rows per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 row padding: conflict-free fragment loads, 16-byte rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;               // (B*H, Sq), contiguous
  int64_t q_sb, q_sh, q_ss; // element strides of q over (batch, head, seq)
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int heads, sq, sk, d;
  float scale_log2;         // scale * log2(e)
};

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
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

// Copies rows [row0, row0 + 64) of one (batch, head) slice into a padded smem
// tile; rows past `rows` are zero-filled. Only the d real columns are copied.
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, int ld, const __nv_bfloat16* base,
                                          int64_t row_stride, int row0, int rows, int d) {
  const int chunks = d / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBlockN * chunks; c += kThreads) {
    const int r = c / chunks;
    const int col = (c - r * chunks) * 8;
    const bool valid = row0 + r < rows;
    const __nv_bfloat16* src = valid ? base + (int64_t)(row0 + r) * row_stride + col : base;
    cp_async_16(tile + r * ld + col, src, valid);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Args args) {
  constexpr int LD = DP + kPad;
  constexpr int KCH = DP / 16;  // k-chunks of the QK^T product
  constexpr int DT = DP / 8;    // n-tiles of the PV product
  constexpr int NT = kBlockN / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv_s = q_s + kBlockM * LD;  // [stage][K|V][64][LD]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group

  const int bh = blockIdx.y;
  const int b = bh / args.heads;
  const int h = bh - b * args.heads;
  const int m0 = blockIdx.x * kBlockM;
  const int d = args.d;

  const __nv_bfloat16* qg = args.q + b * args.q_sb + h * args.q_sh;
  const __nv_bfloat16* kg = args.k + b * args.k_sb + h * args.k_sh;
  const __nv_bfloat16* vg = args.v + b * args.v_sb + h * args.v_sh;

  // zero the head-dim padding columns [d, DP) of every tile once; cp.async
  // never writes them
  if (d < DP) {
    const int padc = DP - d;
    for (int i = tid; i < 5 * kBlockN * padc; i += kThreads) {
      const int r = i / padc;
      q_s[r * LD + d + (i - r * padc)] = __float2bfloat16(0.f);
    }
  }

  const int n_tiles = (args.sk + kBlockN - 1) / kBlockN;
  load_tile(q_s, LD, qg, args.q_ss, m0, args.sq, d);
  load_tile(kv_s, LD, kg, args.k_ss, 0, args.sk, d);
  load_tile(kv_s + kBlockN * LD, LD, vg, args.v_ss, 0, args.sk, d);
  cp_async_commit();

  uint32_t qf[KCH][4];
  float o_acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o_acc[i][j] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // log2-domain running max, rows g and g+8
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      __nv_bfloat16* nxt = kv_s + ((j + 1) & 1) * 2 * kBlockN * LD;
      load_tile(nxt, LD, kg, args.k_ss, (j + 1) * kBlockN, args.sk, d);
      load_tile(nxt + kBlockN * LD, LD, vg, args.v_ss, (j + 1) * kBlockN, args.sk, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
      const __nv_bfloat16* qb = q_s + (warp * 16 + g) * LD + 2 * t;
#pragma unroll
      for (int kc = 0; kc < KCH; ++kc) {
        qf[kc][0] = *reinterpret_cast<const uint32_t*>(qb + kc * 16);
        qf[kc][1] = *reinterpret_cast<const uint32_t*>(qb + 8 * LD + kc * 16);
        qf[kc][2] = *reinterpret_cast<const uint32_t*>(qb + kc * 16 + 8);
        qf[kc][3] = *reinterpret_cast<const uint32_t*>(qb + 8 * LD + kc * 16 + 8);
      }
    }

    const __nv_bfloat16* k_s = kv_s + (j & 1) * 2 * kBlockN * LD;
    const __nv_bfloat16* v_s = k_s + kBlockN * LD;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kb = k_s + (nt * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kc = 0; kc < KCH; ++kc) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kb + kc * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kb + kc * 16 + 8);
        mma_bf16(s[nt], qf[kc], b0, b1);
      }
    }

    // online softmax in the log2 domain; keys past Sk get -inf
    const int key0 = j * kBlockN;
    const bool ragged = key0 + kBlockN > args.sk;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * args.scale_log2;
        if (ragged && key0 + nt * 8 + 2 * t + (e & 1) >= args.sk) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: every tile has a real key
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = p;
        l_run[e >> 1] += p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o_acc[dt][0] *= alpha[0];
      o_acc[dt][1] *= alpha[0];
      o_acc[dt][2] *= alpha[1];
      o_acc[dt][3] *= alpha[1];
    }

    // O += P V: P re-packed from the score accumulators as bf16 A fragments,
    // V fragments read transposed by ldmatrix
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const __nv_bfloat16* vrow = v_s + (kc * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + dt * 8);
        mma_bf16(o_acc[dt], pa, vb[0], vb[1]);
        mma_bf16(o_acc[dt + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }

  // epilogue: full row sums across the quad, normalise, store O and LSE
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    if (row >= args.sq) continue;
    __nv_bfloat16* orow = args.o + b * args.o_sb + h * args.o_sh + (int64_t)row * args.o_ss;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < d) {
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o_acc[dt][2 * r] * inv[r], o_acc[dt][2 * r + 1] * inv[r]);
      }
    }
    if (t == 0) {
      args.lse[(int64_t)bh * args.sq + row] = (m_run[r] + log2f(l_run[r])) * kLn2;
    }
  }
}

template <int DP>
cudaError_t launch(const Args& args, int bh, cudaStream_t stream) {
  const int smem = (kBlockM + 4 * kBlockN) * (DP + kPad) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((args.sq + kBlockM - 1) / kBlockM, bh);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers; strides are in
// elements over (batch, head, seq) for q/k/v/o, whose last dim must be
// contiguous. lse is a contiguous (batch*heads, sq) f32 buffer. Returns a
// cudaError_t (0 on success); an unsupported head dim returns
// cudaErrorInvalidValue without launching.
extern "C" int pnpi_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int batch, int heads, int sq, int sk, int d, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 128 || d % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Args args;
  args.q = static_cast<const __nv_bfloat16*>(q);
  args.k = static_cast<const __nv_bfloat16*>(k);
  args.v = static_cast<const __nv_bfloat16*>(v);
  args.o = static_cast<__nv_bfloat16*>(o);
  args.lse = static_cast<float*>(lse);
  args.q_sb = q_sb; args.q_sh = q_sh; args.q_ss = q_ss;
  args.k_sb = k_sb; args.k_sh = k_sh; args.k_ss = k_ss;
  args.v_sb = v_sb; args.v_sh = v_sh; args.v_ss = v_ss;
  args.o_sb = o_sb; args.o_sh = o_sh; args.o_ss = o_ss;
  args.heads = heads;
  args.sq = sq;
  args.sk = sk;
  args.d = d;
  args.scale_log2 = scale * kLog2e;
  const int bh = batch * heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16 * 16) {
    case 16: return (int)launch<16>(args, bh, st);
    case 32: return (int)launch<32>(args, bh, st);
    case 48: return (int)launch<48>(args, bh, st);
    case 64: return (int)launch<64>(args, bh, st);
    case 80: return (int)launch<80>(args, bh, st);
    case 96: return (int)launch<96>(args, bh, st);
    case 112: return (int)launch<112>(args, bh, st);
    case 128: return (int)launch<128>(args, bh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
