// Exact softmax attention for tiny heads, forward: per (batch, head),
//
//   out = softmax(q k^T * scale) v      q, k, v, out (S, D), D <= 8
//   lse = log2 sum_j 2^(q k_j^T * scale * log2 e)   (base 2, fp32, per row)
//
// with fp32 scores and an fp32 softmax over all S keys, written in the
// inputs' dtype, and the (S, S) scores never written to device memory. `lse`
// is what the backward (tinyhead_attention_bwd.cu) rebuilds the
// probabilities from; the wrapper passes a null pointer when no gradient is
// needed (serving), and then it is not written.
//
// Replaces the TPU kernel masked_diffusion_tpu/ops/pallas/tinyhead_attention.py:
// tinyhead_attention (:99; pallas_call at :131, body _kernel :61), which the
// zoo's attention blocks run at S = 256, 1024 and 4096 with 8-wide heads.
// Layout: q, k, v and out as they lie in (B, heads, S, D), B*heads rows of S*D
// values; the TPU kernel's head-major (BH, 8, S) layout with S padded to 128
// is a fact of the TPU's (8, 128) tile and is not carried over.
//
// Bound. Per (b, h) the two products are 4*S^2*D operations and every score
// needs one exponential. With 8-wide heads the products take 1/8 of what the
// exponentials take: the special-function units issue 16 exp2 per clock per
// SM (CUDA C++ Programming Guide, arithmetic throughput, compute capability
// 9.0), 132 SMs, ~1.98 GHz: ~4.2e12 a second, against 989e12 bf16
// tensor-core operations. So the exponentials bound the kernel, and the
// design keeps every other instruction per score few.
//
// bf16: tinyhead_fwd_mma_kernel, the JAX kernel's own recipe (bf16 products
// with fp32 accumulation, fp32 online softmax, P rounded to bf16 for the
// second product). A block of 4 warps owns 128 queries; a warp owns two
// 16-row tiles, its q as mma A fragments in registers. K and V stream through
// shared memory in tiles of 128 rows (each thread fetches one K and one V
// row of the next tile into registers while the block computes on the
// current one: one __syncthreads per tile). Per chunk of 64 keys:
//   S = q K^T         8 x mma.m16n8k8 per 16 rows (contraction = the head,
//                     zero-padded to 8), K^T fragments by ldmatrix
//   row max           over the lane's 16 scores, then 2 shuffles in its quad
//   P = 2^(S c - m c) one FFMA and one ex2.approx per score (c = scale log2 e)
//   acc *= 2^(m_old c - m c) once per chunk and row
//   acc += P V        4 x mma.m16n8k16: the score fragments, rounded in pairs
//                     by one cvt.rn.bf16x2, are the A fragments; V by
//                     ldmatrix.trans
// The row sums stay per lane and meet in the quad once, at the end. mma.sync
// and not wgmma: wgmma needs a contraction of 16 (the head padded 2x) and
// 64-row warpgroup tiles, and the products are not what bounds the kernel.
//
// fp32: tinyhead_fwd_kernel, both products in fp32 on the CUDA cores (Hopper
// has no fp32 tensor-core product without TF32, which would change the
// numerics against the JAX package's fp32 path): one thread per query, K/V
// tiles of 128 rows widened into shared memory, the online softmax in base 2
// rescaled once per 16 keys.
//
// The online softmax differs from the full-row softmax of the TPU kernel and
// of the plain version only by rounding.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tinyhead_mma.cuh"

namespace {

using tinyhead::kD;
using tinyhead::kLog2e;

// ---- bf16: tensor cores -------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMT = 2;                      // 16-row query tiles per warp
constexpr int kRows = kWarps * kMT * 16;    // queries per block
constexpr int kKT = kThreads;               // K/V rows per shared tile: one per thread
constexpr int kChunk = 64;                  // keys per online-softmax step

__global__ void __launch_bounds__(kThreads, 4) tinyhead_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int s, int d, float c) {
  using namespace tinyhead;
  __shared__ __align__(16) uint4 ks[2][kKT];
  __shared__ __align__(16) uint4 vs[2][kKT];

  const size_t head = static_cast<size_t>(blockIdx.x) * s * d;
  q += head;
  k += head;
  v += head;
  out += head;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kRows + warp * kMT * 16;

  uint32_t qa[kMT][2];
  float acc[kMT][4], m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qa[mt][r] = load_pair(q, row0 + mt * 16 + g + 8 * r, 2 * t, s, d);
      m[mt][r] = -INFINITY;  // running max of the raw scores
      l[mt][r] = 0.f;        // this lane's part of the running sum
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0.f;
  }

  const int tiles = (s + kKT - 1) / kKT;
  uint4 kr = load_row(k, tid, s, d), vr = load_row(v, tid, s, d);
  ks[0][tid] = kr;
  vs[0][tid] = vr;
  for (int tile = 0; tile < tiles; ++tile) {
    const int j0 = tile * kKT;
    if (tile + 1 < tiles) {  // the next tile's rows, in flight during this one
      kr = load_row(k, j0 + kKT + tid, s, d);
      vr = load_row(v, j0 + kKT + tid, s, d);
    }
    __syncthreads();  // this tile stored; every warp done with the other buffer
    const uint4* kt = ks[tile & 1];
    const uint4* vt = vs[tile & 1];
    const int n = min(kKT, s - j0);  // valid keys in the tile; rows past it are 0

    for (int c0 = 0; c0 < n; c0 += kChunk) {  // every chunk has a valid key
      uint32_t kb[8], vb[4][2], r4[4];
      ldsm_x4(r4, kt + c0 + lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) kb[i] = r4[i];
      ldsm_x4(r4, kt + c0 + 32 + lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) kb[4 + i] = r4[i];
      ldsm_x4_t(r4, vt + c0 + lane);
      vb[0][0] = r4[0]; vb[0][1] = r4[1]; vb[1][0] = r4[2]; vb[1][1] = r4[3];
      ldsm_x4_t(r4, vt + c0 + 32 + lane);
      vb[2][0] = r4[0]; vb[2][1] = r4[1]; vb[3][0] = r4[2]; vb[3][1] = r4[3];
      const bool ragged = c0 + kChunk > n;

#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        float sc[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
          mma_k8(sc[nt], qa[mt], kb[nt]);
        }
        if (ragged) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (c0 + nt * 8 + 2 * t + (i & 1) >= n) sc[nt][i] = -INFINITY;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(sc[nt][2 * r], sc[nt][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mn = fmaxf(m[mt][r], mx);
          const float corr = ex2((m[mt][r] - mn) * c);  // 0 on the first chunk
          m[mt][r] = mn;
          acc[mt][2 * r] *= corr;
          acc[mt][2 * r + 1] *= corr;
          const float mc = mn * c;
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            sc[nt][2 * r] = ex2(fmaf(sc[nt][2 * r], c, -mc));  // 0 for masked keys
            sc[nt][2 * r + 1] = ex2(fmaf(sc[nt][2 * r + 1], c, -mc));
            sum += sc[nt][2 * r] + sc[nt][2 * r + 1];
          }
          l[mt][r] = fmaf(l[mt][r], corr, sum);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t pa[4] = {
              pack_bf16(sc[2 * kk][0], sc[2 * kk][1]), pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
          mma_k16(acc[mt], pa, vb[kk]);
        }
      }
    }
    if (tile + 1 < tiles) {
      ks[(tile + 1) & 1][tid] = kr;
      vs[(tile + 1) & 1][tid] = vr;
    }
  }

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[mt][r];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = row0 + mt * 16 + g + 8 * r;
      const float inv = 1.f / lt;
      store_pair(out, row, 2 * t, s, d, acc[mt][2 * r] * inv, acc[mt][2 * r + 1] * inv);
      if (lse != nullptr && t == 0 && row < s) {
        lse[static_cast<size_t>(blockIdx.x) * s + row] = fmaf(m[mt][r], c, log2f(lt));
      }
    }
  }
}

// ---- fp32: CUDA cores -----------------------------------------------------

constexpr int kQ = 128;     // queries per block = threads per block
constexpr int kKTF = kQ;    // K/V rows per shared-memory tile: one per thread
constexpr int kChunkF = 16; // keys per online-softmax update

__global__ void __launch_bounds__(kQ) tinyhead_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int s, int d, float scale_log2) {
  __shared__ float ks[kKTF][kD];
  __shared__ float vs[kKTF][kD];

  const size_t head = static_cast<size_t>(blockIdx.x) * s * d;
  const int tid = threadIdx.x;
  const int qi = blockIdx.y * kQ + tid;
  const bool valid = qi < s;

  float qr[kD], acc[kD];
#pragma unroll
  for (int c = 0; c < kD; ++c) {
    qr[c] = (valid && c < d) ? q[head + static_cast<size_t>(qi) * d + c] * scale_log2 : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY;  // running max of the scores (base 2)
  float l = 0.f;        // running sum of 2^(score - m)

  for (int j0 = 0; j0 < s; j0 += kKTF) {
    const int n = min(kKTF, s - j0);
    __syncthreads();  // every thread is done with the previous tile
    if (tid < n) {
      const size_t r = head + static_cast<size_t>(j0 + tid) * d;
#pragma unroll
      for (int c = 0; c < kD; ++c) {
        ks[tid][c] = c < d ? k[r + c] : 0.f;
        vs[tid][c] = c < d ? v[r + c] : 0.f;
      }
    }
    __syncthreads();

    // every chunk holds at least one valid key, so m is finite after the
    // first and 2^(m - m_new) is 0, not NaN, on the first rescale
    for (int c0 = 0; c0 < n; c0 += kChunkF) {
      float sc[kChunkF];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunkF; ++j) {
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
      for (int j = 0; j < kChunkF; ++j) {
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
    float* row = out + head + static_cast<size_t>(qi) * d;
#pragma unroll
    for (int c = 0; c < kD; ++c) {
      if (c < d) row[c] = acc[c] * inv;
    }
    if (lse != nullptr) lse[static_cast<size_t>(blockIdx.x) * s + qi] = m + log2f(l);
  }
}

}  // namespace

// q, k, v, out: bh rows of (s, d) values, dtype 0 = fp32, 1 = bf16; lse:
// (bh, s) fp32, or null when no gradient is needed.
extern "C" int mdt_tinyhead_attention(const void* q, const void* k, const void* v, void* out,
                                      void* lse, int bh, int s, int d, float scale, int dtype,
                                      void* stream) {
  static_assert(kRows == kQ, "both instances take 128 queries a block");
  const int tiles = s > 0 ? (s + kQ - 1) / kQ : 0;
  if (bh <= 0 || s <= 0 || d <= 0 || d > kD || tiles > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(bh, tiles);
  const float c = scale * kLog2e;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    tinyhead_fwd_kernel<<<grid, kQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), static_cast<float*>(lse), s, d, c);
  } else {
    tinyhead_fwd_mma_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(lse), s, d, c);
  }
  return static_cast<int>(cudaGetLastError());
}
