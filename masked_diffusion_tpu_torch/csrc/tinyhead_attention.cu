// Exact softmax attention for tiny heads: per (batch, head),
//
//   out = softmax(q k^T * scale) v      q, k, v, out (S, D), D <= 8
//
// with fp32 scores and an fp32 softmax over all S keys, written in the
// inputs' dtype (fp32 or bf16), and the (S, S) scores never written to
// device memory.
//
// Replaces the TPU kernel masked_diffusion_tpu/ops/pallas/tinyhead_attention.py:
// tinyhead_attention (:99; pallas_call at :131, body _kernel :61), which the
// zoo's attention blocks run at S = 256, 1024 and 4096 with 8-wide heads.
//
// Layout. q, k, v and out are read and written as they lie in (B, heads, S,
// D): B*heads rows of S*D values. The TPU kernel's head-major (BH, 8, S)
// layout with S padded to 128 is a fact of the TPU's (8, 128) tile and is
// not carried over: here a query of 8 values is 32 bytes (fp32) or 16 (bf16),
// and the ragged edge of S is masked per tile.
//
// Design. One block of kQ = 128 threads per (b*h, tile of 128 queries);
// each thread keeps one query's 8 values (pre-multiplied by scale*log2 e),
// its running max and sum, and an fp32 accumulator of 8. K and V stream
// through shared memory in tiles of 128 rows, widened to fp32 and zero-padded
// to 8 columns; rows past S are never read. Within a tile the keys are taken
// 16 at a time: 16 scores in registers, one rescale of the accumulator per
// chunk (the online softmax, in base 2), then the 16 weighted rows of V. The
// output is acc / sum, written once.
//
// The online softmax differs from the full-row softmax of the TPU kernel and
// of the plain version only by rounding: each score is rescaled by 2^(m_old
// - m_new) at most once per chunk instead of normalised once per row.
//
// Bound. Per (b, h) the two products are 4*S^2*D operations and the softmax
// ~5*S^2; q, k, v and out are 4*S*D values. At the zoo's shapes (S >= 256,
// D = 8) that is >= 256 operations per byte, so the work bounds it, not the
// bytes. This kernel runs both products on the CUDA cores in fp32 (16 FMAs
// per query-key pair besides the exponential), so fp32 instruction
// throughput bounds it, well above the tensor-core bound of the same
// products; mma.sync/wgmma for the products (and several queries per
// thread, to reuse each K/V row read from shared memory) are the way down.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 8;       // head_dim capacity
constexpr int kQ = 128;     // queries per block = threads per block
constexpr int kKT = kQ;     // K/V rows per shared-memory tile: one per thread
constexpr int kChunk = 16;  // keys per online-softmax update
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kQ) tinyhead_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int s, int d, float scale_log2) {
  __shared__ float ks[kKT][kD];
  __shared__ float vs[kKT][kD];

  const size_t head = static_cast<size_t>(blockIdx.x) * s * d;
  const int tid = threadIdx.x;
  const int qi = blockIdx.y * kQ + tid;
  const bool valid = qi < s;

  float qr[kD], acc[kD];
#pragma unroll
  for (int c = 0; c < kD; ++c) {
    qr[c] = (valid && c < d) ? widen(q[head + static_cast<size_t>(qi) * d + c]) * scale_log2
                             : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY;  // running max of the scores (base 2)
  float l = 0.f;        // running sum of 2^(score - m)

  for (int j0 = 0; j0 < s; j0 += kKT) {
    const int n = min(kKT, s - j0);
    __syncthreads();  // every thread is done with the previous tile
    if (tid < n) {
      const size_t r = head + static_cast<size_t>(j0 + tid) * d;
#pragma unroll
      for (int c = 0; c < kD; ++c) {
        ks[tid][c] = c < d ? widen(k[r + c]) : 0.f;
        vs[tid][c] = c < d ? widen(v[r + c]) : 0.f;
      }
    }
    __syncthreads();

    // every chunk holds at least one valid key, so m is finite after the
    // first and 2^(m - m_new) is 0, not NaN, on the first rescale
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      float sc[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float x = -INFINITY;
        if (c0 + j < n) {
          x = 0.f;
#pragma unroll
          for (int c = 0; c < kD; ++c) x = fmaf(qr[c], ks[c0 + j][c], x);
        }
        sc[j] = x;
        cmax = fmaxf(cmax, x);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = exp2f(m - m_new);
      l *= corr;
#pragma unroll
      for (int c = 0; c < kD; ++c) acc[c] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = exp2f(sc[j] - m_new);  // 0 for keys past S
        l += p;
        if (c0 + j < n) {
#pragma unroll
          for (int c = 0; c < kD; ++c) acc[c] = fmaf(p, vs[c0 + j][c], acc[c]);
        }
      }
      m = m_new;
    }
  }

  if (valid) {
    const float inv = 1.f / l;
    T* row = out + head + static_cast<size_t>(qi) * d;
#pragma unroll
    for (int c = 0; c < kD; ++c) {
      if (c < d) row[c] = narrow<T>(acc[c] * inv);
    }
  }
}

}  // namespace

// q, k, v, out: bh rows of (s, d) values, dtype 0 = fp32, 1 = bf16.
extern "C" int mdt_tinyhead_attention(const void* q, const void* k, const void* v,
                                      void* out, int bh, int s, int d, float scale,
                                      int dtype, void* stream) {
  const int tiles = s > 0 ? (s + kQ - 1) / kQ : 0;
  if (bh <= 0 || s <= 0 || d <= 0 || d > kD || tiles > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(bh, tiles);
  const float scale_log2 = scale * kLog2e;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    tinyhead_kernel<float><<<grid, kQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), s, d, scale_log2);
  } else {
    tinyhead_kernel<__nv_bfloat16><<<grid, kQ, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), s, d,
        scale_log2);
  }
  return static_cast<int>(cudaGetLastError());
}
