// Building blocks of the tiny-head attention kernels (tinyhead_attention.cu,
// tinyhead_attention_bwd.cu): warp-level bf16 tensor-core products
// (mma.sync, sm_80 and later), shared-memory fragment loads (ldmatrix), the
// base-2 exponential on the special-function unit, and row loads of the
// (B*heads, S, D <= 8) tensors.
//
// Fragments (PTX ISA, mma.m16n8k8 / m16n8k16 with .bf16): in a warp, lane
// = 4*g + t (g = lane / 4, t = lane % 4).
//   A (16 x 8):    a[0] = A[g][2t..2t+1],  a[1] = A[g+8][2t..2t+1]
//   A (16 x 16):   a[0], a[1] as above for columns 0..7, a[2], a[3] for 8..15
//   B (8 x 8):     b    = B[2t..2t+1][g]
//   B (16 x 8):    b[0] = B[2t..2t+1][g],  b[1] = B[8+2t..8+2t+1][g]
//   C, D (16 x 8): c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1]
// So the C fragments of two 16 x 8 products, rounded to bf16 in pairs, are
// the A fragment of one 16 x 16 product: a score tile feeds the next product
// from registers.
//
// A row of D <= 8 bf16 values, zero-padded to 8, is 16 bytes: a tile of rows
// in shared memory is an array of uint4, and ldmatrix reads 8 rows (one 8 x 8
// matrix) in one conflict-free phase. Without .trans a lane receives row g,
// columns 2t..2t+1 of each matrix: the B fragment of X^T for X stored by
// rows. With .trans it receives rows 2t..2t+1 of column g: the B fragment of
// X itself.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace tinyhead {

constexpr int kD = 8;  // head_dim capacity
constexpr float kLog2e = 1.4426950408889634f;

// d += a b, m16n8k8, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// d += a b, m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8 x 8 bf16 matrices: lane L gives the address of row L (rows 8i..8i+7
// are matrix i), so `rows + lane` reads 32 consecutive rows
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint4* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const uint4* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// 2^x on the special-function unit: one MUFU.EX2, 2^-22 relative error,
// 2^-inf = +0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values rounded to nearest bf16 in one packed cvt; lo in bits 0..15
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float lo_f32(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float hi_f32(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

__device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }

// columns col, col+1 of row `row` of an (s, d) bf16 matrix as one packed
// pair, zero past d and for rows past s
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base, int row, int col,
                                              int s, int d) {
  if (row >= s) return 0u;
  const __nv_bfloat16* p = base + static_cast<size_t>(row) * d + col;
  const uint32_t lo = col < d ? bits(p[0]) : 0u;
  const uint32_t hi = col + 1 < d ? bits(p[1]) : 0u;
  return lo | (hi << 16);
}

// row `row` of an (s, d) bf16 matrix zero-padded to 8 values; zero past s.
// d == 8 rows are 16-byte aligned (the wrapper checks the base pointers).
__device__ __forceinline__ uint4 load_row(const __nv_bfloat16* base, int row, int s, int d) {
  if (row >= s) return make_uint4(0u, 0u, 0u, 0u);
  const __nv_bfloat16* p = base + static_cast<size_t>(row) * d;
  if (d == kD) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int c = 0; c < d; ++c) w[c >> 1] |= bits(p[c]) << (16 * (c & 1));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// sum over the 8 columns of a*b in fp32, for two packed bf16 rows
__device__ __forceinline__ float dot_row(uint4 a, uint4 b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(lo_f32(x[i]), lo_f32(y[i]), acc);
    acc = fmaf(hi_f32(x[i]), hi_f32(y[i]), acc);
  }
  return acc;
}

// store the pair (c0, c1) of row `row`, columns col, col+1, rounded to bf16,
// where they lie within (s, d)
__device__ __forceinline__ void store_pair(__nv_bfloat16* base, int row, int col, int s, int d,
                                           float c0, float c1) {
  if (row >= s) return;
  __nv_bfloat16* p = base + static_cast<size_t>(row) * d + col;
  if (col < d) p[0] = __float2bfloat16_rn(c0);
  if (col + 1 < d) p[1] = __float2bfloat16_rn(c1);
}

}  // namespace tinyhead
