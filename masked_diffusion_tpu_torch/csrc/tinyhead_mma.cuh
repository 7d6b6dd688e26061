// Building blocks of the tiny-head attention kernels (tinyhead_attention.cu,
// tinyhead_attention_bwd.cu): warp-level bf16 and tf32 tensor-core products
// (mma.sync, sm_80 and later), the split-TF32 product at fp32 accuracy,
// shared-memory fragment loads (ldmatrix), the base-2 exponential on the
// special-function unit, and row loads of the (B*heads, S, D <= 8) tensors.
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
// With .tf32 (m16n8k8, one 32-bit value a register):
//   A (16 x 8):    a[0] = A[g][t], a[1] = A[g+8][t], a[2] = A[g][t+4], a[3] = A[g+8][t+4]
//   B (8 x 8):     b[0] = B[t][g], b[1] = B[t+4][g]
//   C, D (16 x 8): as above
// A C fragment is the A fragment of the next product with its contraction
// index permuted, column t standing for 2t and column t+4 for 2t+1
// (c2a below): the next product's B takes rows 2t and 2t+1 to match. No
// shuffle. An 8 x 4 block of fp32 values is an 8 x 8 block of b16 pairs,
// so ldmatrix (no .trans) gives lane 4g+t the value at row g, column t.
//
// Split TF32 (CUTLASS's "3xTF32"): x = hi + lo with hi = tf32(x), rounded
// to nearest by cvt.rna, and lo = x - hi, exact in fp32 and passed as it
// is: the tensor cores read a tf32 operand's 19 high bits, so lo enters
// truncated to tf32 (as CUTLASS's fast-accurate fp32 passes its small
// part; a second cvt.rna cost 7% of the backward's time on an H100). hi
// carries 11 significant bits and lo the next 11, so hi + lo is x to about
// 2^-21 relative. A product a b takes three tf32 products, a_lo b_hi +
// a_hi b_lo + a_hi b_hi (a_lo b_lo, 2^-22 relative, is dropped), each
// product exact and summed in fp32: fp32 accuracy from the tensor cores,
// where one tf32 product keeps 2^-11. The tensor cores sum a product's
// terms in fp32 without rounding to nearest, so the kernels keep every
// chain of tensor-core sums short (a chunk's worth) and add the chunks on
// the CUDA cores. torch.backends.cuda.matmul.allow_tf32 does not govern
// these kernels: they never round a product's input to one tf32 value.
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

// d += a b, m16n8k8, tf32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32, to nearest with ties away from zero
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi tf32, lo the exact rest, which a tf32 product truncates
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// the C fragment's value that is register i of the next product's A
// fragment: (row g, col 2t), (g+8, 2t), (g, 2t+1), (g+8, 2t+1)
__host__ __device__ constexpr int c2a(int i) { return (i & 1) * 2 + (i >> 1); }

// d += a b at fp32 accuracy, split TF32: a = {hi, lo} A fragments, b = {hi
// b[0], hi b[1], lo b[0], lo b[1]} (the register order of an ldmatrix.x4 of
// the hi and lo matrices); the small terms first
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const uint32_t (&a)[2][4],
                                           const uint32_t (&b)[4]) {
  mma_tf32(d, a[1], b[0], b[1]);
  mma_tf32(d, a[0], b[2], b[3]);
  mma_tf32(d, a[0], b[0], b[1]);
}

// cp.async of `bytes` (4 or 16) from global to shared memory; zero-filled
// when !valid (src must still be a valid address)
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
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

// row `row` of an (s, d) fp32 matrix zero-padded to 8 values; zero past s.
// d == 8 rows are 16-byte aligned (the wrapper checks the base pointers).
__device__ __forceinline__ void load_row(const float* base, int row, int s, int d,
                                         float (&r)[kD]) {
  if (row >= s) {
#pragma unroll
    for (int c = 0; c < kD; ++c) r[c] = 0.f;
    return;
  }
  const float* p = base + static_cast<size_t>(row) * d;
  if (d == kD) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
    return;
  }
#pragma unroll
  for (int c = 0; c < kD; ++c) r[c] = c < d ? p[c] : 0.f;
}

// element (row, col) of an (s, d) fp32 matrix, zero outside it
__device__ __forceinline__ float load_at(const float* base, int row, int col, int s, int d) {
  return row < s && col < d ? base[static_cast<size_t>(row) * d + col] : 0.f;
}

// offset (in floats) of 16-byte half h (columns 4h..4h+3) of row r in a
// shared-memory array of 8-float rows, the halves of rows 4..7 of every 8
// swapped: the 8 rows an ldmatrix phase reads fall in distinct banks
__device__ __forceinline__ int swz(int r, int h) { return r * kD + 4 * (h ^ ((r >> 2) & 1)); }

// position of index j in a run of 8 stored as 0, 2, 4, 6, 1, 3, 5, 7: the
// layout in which an ldmatrix of 4-value columns gives a lane the values at
// 2t (first matrix) and 2t+1 (second), a tf32 B fragment with c2a's order
__device__ __forceinline__ int pair_pos(int j) {
  return (j & ~7) | ((j & 1) << 2) | ((j >> 1) & 3);
}

// the four ldmatrix matrices {hi, hi, lo, lo} x {columns c, c+4} of 8 rows
// of a row-major 8-float array pair (hi at `hi`, lo at `lo`): lane L's row
// address. Gives the tf32 B fragment {hi b0, hi b1, lo b0, lo b1} of the
// transposed rows (b0 = X[row g][t], b1 = X[g][t+4])
__device__ __forceinline__ const uint4* frag_rows(const float* hi, const float* lo, int row0,
                                                  int lane) {
  const float* base = lane < 16 ? hi : lo;
  return reinterpret_cast<const uint4*>(base + swz(row0 + (lane & 7), (lane >> 3) & 1));
}

// the same from a transposed pair ([dim][pair_pos(j)] at `stride` floats a
// dim): {hi b0, hi b1, lo b0, lo b1} with b0 = X[j0 + 2t][g], b1 = X[j0 +
// 2t + 1][g] for the 8 indices from j0
__device__ __forceinline__ const uint4* frag_cols(const float* hi, const float* lo, int j0,
                                                  int stride, int lane) {
  const float* base = lane < 16 ? hi : lo;
  return reinterpret_cast<const uint4*>(base + (lane & 7) * stride + j0 + 4 * ((lane >> 3) & 1));
}

// row `r` (8 fp32 values) split into tf32 hi and lo, stored at row r of the
// swizzled row-major pair and at index r of the transposed pair
__device__ __forceinline__ void store_split(const float (&x)[kD], int r, float* rhi, float* rlo,
                                            float* thi, float* tlo, int stride) {
  uint32_t h[kD], l[kD];
#pragma unroll
  for (int c = 0; c < kD; ++c) split_tf32(x[c], h[c], l[c]);
  const int p = pair_pos(r);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    *reinterpret_cast<uint4*>(rhi + swz(r, half)) =
        make_uint4(h[4 * half], h[4 * half + 1], h[4 * half + 2], h[4 * half + 3]);
    *reinterpret_cast<uint4*>(rlo + swz(r, half)) =
        make_uint4(l[4 * half], l[4 * half + 1], l[4 * half + 2], l[4 * half + 3]);
  }
#pragma unroll
  for (int c = 0; c < kD; ++c) {
    thi[c * stride + p] = __uint_as_float(h[c]);
    tlo[c * stride + p] = __uint_as_float(l[c]);
  }
}

// store the pair (c0, c1) of row `row`, columns col, col+1, where they lie
// within (s, d)
__device__ __forceinline__ void store_pair(float* base, int row, int col, int s, int d, float c0,
                                           float c1) {
  if (row >= s) return;
  float* p = base + static_cast<size_t>(row) * d + col;
  if (col + 1 < d && !(d & 1)) {
    *reinterpret_cast<float2*>(p) = make_float2(c0, c1);  // col and d even: 8-byte aligned
  } else {
    if (col < d) p[0] = c0;
    if (col + 1 < d) p[1] = c1;
  }
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
