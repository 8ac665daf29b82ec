// The 3xTF32 building blocks of the f32 flash kernels (sm_90a):
// flash_attention_fwd_f32.cu and flash_attention_bwd_f32.cu.
//
// - tf32_hi / split4: x = hi + lo, hi = tf32(x) rounded to nearest (ties
//   away), lo = x - hi exact in f32. A B = A_hi B_lo + A_lo B_hi + A_hi B_hi
//   drops only A_lo B_lo, about 2^-22 of |A||B|.
// - The no-swizzle core-matrix layout that every tile of these kernels is
//   kept in, in shared memory and in the split passes' output: 8x4 blocks of
//   128 contiguous bytes, row groups outermost (cm_desc). A transposed tile
//   (a K-major B operand whose K dimension is a sequence: V^T, K^T, Q^T,
//   dO^T) keeps each group of 8 positions in the order 0 2 4 6 1 3 5 7
//   (ops/flash_attention.py::F32_KEY_PERM), so that an accumulator of the
//   product before it is the TF32 A fragment as it stands.
// - mma3_ss / mma3_rs: one 3xTF32 product as three wgmma chains, the two
//   small terms first and hi hi last.
#pragma once

#include "hopper_common.cuh"
#include "wgmma_tf32.cuh"

namespace {

// wgmma descriptor (no swizzle) of a K-major tile with kdim columns stored
// as 8x4 core matrices (8 rows of 16 bytes, 128 contiguous bytes), row groups
// outermost: element (row, col) at byte ((row / 8) (kdim / 4) + col / 4) 128 +
// (row % 8) 16 + (col % 4) 4. 128 bytes between column chunks (LBO), 32 kdim
// between row groups (SBO); a k-step of 8 columns starts 256 bytes on.
__device__ __forceinline__ uint64_t cm_desc(uint32_t addr, int kdim) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((32 * kdim) >> 4) << 32);
}

// hi = tf32(x), rounded to nearest (ties away), low 13 bits zero
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xFFFFE000u;
}

__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  hi = make_float4(__uint_as_float(tf32_hi(x.x)), __uint_as_float(tf32_hi(x.y)),
                   __uint_as_float(tf32_hi(x.z)), __uint_as_float(tf32_hi(x.w)));
  lo = make_float4(x.x - hi.x, x.y - hi.y, x.z - hi.z, x.w - hi.w);
}

// The i-th 16 bytes of a tile of rows [row0, row0 + t) x d columns of a
// (seq, d) slice with row stride ss, in core-matrix order (kdim d); zero at
// and past `rows`. Consecutive i read consecutive rows of a column chunk.
__device__ __forceinline__ float4 row_chunk(const float* x, int64_t ss, int row0, int rows, int d,
                                            int i) {
  const int cm = i >> 3, d4 = d / 4;
  const int row = row0 + 8 * (cm / d4) + (i & 7), cc = cm % d4;
  return row < rows ? *reinterpret_cast<const float4*>(x + row * ss + 4 * cc)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
}

// The i-th 16 bytes of the same tile transposed (d rows, kdim t), each group
// of 8 sequence positions in the order 0 2 4 6 1 3 5 7: chunk kc of a row
// holds positions 8 (kc / 2) + (kc % 2) + 2 u, u = 0..3.
__device__ __forceinline__ float4 col_chunk(const float* x, int64_t ss, int row0, int rows, int t,
                                            int i) {
  const int cm = i >> 3, t4 = t / 4;
  const int n = 8 * (cm / t4) + (i & 7), kc = cm % t4;
  const int pos = row0 + 8 * (kc >> 1) + (kc & 1);
  float y[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) y[u] = pos + 2 * u < rows ? x[(pos + 2 * u) * ss + n] : 0.f;
  return make_float4(y[0], y[1], y[2], y[3]);
}

__device__ __forceinline__ void st_shared4(uint32_t addr, float4 x) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(x.x), "f"(x.y),
               "f"(x.z), "f"(x.w)
               : "memory");
}

// A warpgroup (tid 0..127) splits 64 rows [row0, row0 + 64) of a (seq, D)
// slice into hi and lo tiles in shared memory (kdim D), zero past `rows`.
template <int D>
__device__ __forceinline__ void split_rows_to_smem(uint32_t hi, uint32_t lo, const float* x,
                                                   int64_t ss, int row0, int rows, int tid) {
  for (int i = tid; i < 16 * D; i += 128) {
    float4 h, l;
    split4(row_chunk(x, ss, row0, rows, D, i), h, l);
    st_shared4(hi + 16 * i, h);
    st_shared4(lo + 16 * i, l);
  }
}

// acc (64 x N) = A B^T over K8 k-steps of 8: A (64 rows) and B (N rows), hi
// and lo, K-major in shared memory; three chains, small terms first. The
// first k-step overwrites acc.
template <int N, int K8>
__device__ __forceinline__ void mma3_ss(float (&acc)[N / 2], uint32_t a_hi, uint32_t a_lo,
                                        uint32_t b_hi, uint32_t b_lo) {
  constexpr int K = 8 * K8;
#pragma unroll
  for (int ks = 0; ks < K8; ++ks)
    WgmmaTf32<N>::ss(acc, cm_desc(a_hi + 256 * ks, K), cm_desc(b_lo + 256 * ks, K), ks > 0);
#pragma unroll
  for (int ks = 0; ks < K8; ++ks)
    WgmmaTf32<N>::ss(acc, cm_desc(a_lo + 256 * ks, K), cm_desc(b_hi + 256 * ks, K), 1);
#pragma unroll
  for (int ks = 0; ks < K8; ++ks)
    WgmmaTf32<N>::ss(acc, cm_desc(a_hi + 256 * ks, K), cm_desc(b_hi + 256 * ks, K), 1);
}

// acc (64 x N) (+)= A B^T over K / 8 k-steps: A from registers (hi and lo,
// an accumulator of a 64 x K product: group c is registers 4c .. 4c + 3 in
// the order 0, 2, 1, 3, since slots t and t + 4 hold positions 2t and 2t + 1),
// B (N rows, kdim K, F32_KEY_PERM order) in shared memory; three chains,
// small terms first. ``zero_first``: the first k-step overwrites acc.
template <int N, int K>
__device__ __forceinline__ void mma3_rs(float (&acc)[N / 2], const uint32_t (&hi)[K / 2],
                                        const uint32_t (&lo)[K / 2], uint32_t b_hi, uint32_t b_lo,
                                        bool zero_first) {
#pragma unroll
  for (int c = 0; c < K / 8; ++c)
    WgmmaTf32<N>::rs(acc, hi[4 * c], hi[4 * c + 2], hi[4 * c + 1], hi[4 * c + 3],
                     cm_desc(b_lo + 256 * c, K), c > 0 || !zero_first);
#pragma unroll
  for (int c = 0; c < K / 8; ++c)
    WgmmaTf32<N>::rs(acc, lo[4 * c], lo[4 * c + 2], lo[4 * c + 1], lo[4 * c + 3],
                     cm_desc(b_hi + 256 * c, K), 1);
#pragma unroll
  for (int c = 0; c < K / 8; ++c)
    WgmmaTf32<N>::rs(acc, hi[4 * c], hi[4 * c + 2], hi[4 * c + 1], hi[4 * c + 3],
                     cm_desc(b_hi + 256 * c, K), 1);
}

// x into its TF32 hi and lo register words
__device__ __forceinline__ void split_reg(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_hi(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

}  // namespace
