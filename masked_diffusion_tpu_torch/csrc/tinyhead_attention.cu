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
// design keeps every other instruction per score few. In fp32 the split
// products take three times the operations at the TF32 rate (494.7e12),
// 96 a score against one exp2: 0.8 of the exponentials' time, where fp32 on
// the CUDA cores (67e12) would take 2.0 of it.
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
// fp32: tinyhead_fwd_tf32_kernel, the same skeleton on the tensor cores in
// split TF32 (tinyhead_mma.cuh: x = hi + lo, three tf32 products a product
// for fp32 accuracy; torch.backends.cuda.matmul.allow_tf32 does not govern
// it). q is scaled by c and split into hi/lo A fragments once, in
// registers; each K and V row is split once, when the block stages it into
// shared memory (its rows land by cp.async; K by rows, V transposed with
// each run of 8 keys stored 0, 2, 4, 6, 1, 3, 5, 7, so that ldmatrix gives
// every B fragment with no arithmetic). Per chunk of 64 keys and 16 queries:
//   S = (q c) K^T     8 x 3 mma.m16n8k8.tf32 (lo hi, hi lo, hi hi)
//   softmax           as bf16, one ex2.approx a score (scores already in base 2)
//   P                 split per score (one cvt.rna.tf32 and a subtraction)
//   pv = P V          8 x 3 mma.m16n8k8.tf32 into four fresh accumulators
//                     (four chains of dependent products, not one of 24):
//                     the C fragment of S is P's A fragment with the keys of
//                     each 8 in the order 0, 2, 4, 6 | 1, 3, 5, 7 (c2a), and
//                     V's B fragment takes keys 2t and 2t+1 to match: no
//                     shuffle
//   acc = acc 2^(m_old - m) + pv, on the CUDA cores
// The tensor cores' sums run over one chunk; chunks meet in fp32 FFMAs, so
// the result keeps fp32 accuracy over 4096 keys. Every score costs six tf32
// products, one ex2 and about six other instructions; mma.sync's tf32 rate
// on the H100 (measured: ~1.8-2.2 SM clocks an m16n8k8, against 1 at the
// dense TF32 peak) makes the products, not the exponentials, the floor.
//
// The online softmax differs from the full-row softmax of the TPU kernel and
// of the plain version only by rounding.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tinyhead_mma.cuh"

namespace {

using tinyhead::cp_async;
using tinyhead::cp_async_commit;
using tinyhead::cp_async_wait;
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

// ---- fp32: tensor cores, split TF32 -------------------------------------

// one 16-byte row of 4 fp32 values a stored row half; V transposed: a dim's
// row of the tile's keys, 4 floats of padding so that an ldmatrix phase's 8
// rows (33 16-byte units apart) fall in distinct banks
constexpr int kVS = kKT + 4;

__global__ void __launch_bounds__(kThreads, 3) tinyhead_fwd_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int s, int d, float c) {
  using namespace tinyhead;
  // [buffer][hi, lo]: K rows (swizzled 8-float rows), V transposed
  __shared__ __align__(16) float ks[2][2][kKT * kD];
  __shared__ __align__(16) float vs[2][2][kD * kVS];
  // the next tile's rows as they land (cp.async, d == 8): thread i's K and V row
  __shared__ __align__(16) float raw[2][kKT * kD];

  const size_t head = static_cast<size_t>(blockIdx.x) * s * d;
  q += head;
  k += head;
  v += head;
  out += head;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kRows + warp * kMT * 16;

  uint32_t qa[kMT][2][4];  // q c as {hi, lo} A fragments
  float acc[kMT][4], m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = load_at(q, row0 + mt * 16 + g + 8 * (i & 1), t + 4 * (i >> 1), s, d);
      split_tf32(x * c, qa[mt][0][i], qa[mt][1][i]);
      acc[mt][i] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -INFINITY;  // running max of the scores (base 2)
      l[mt][r] = 0.f;        // this lane's part of the running sum
    }
  }

  // this thread's K and V row of a tile, split into the shared buffers
  auto store_rows = [&](int buf, const float (&kr)[kD], const float (&vr)[kD]) {
    uint32_t h[kD], lo[kD];
#pragma unroll
    for (int i = 0; i < kD; ++i) split_tf32(kr[i], h[i], lo[i]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      *reinterpret_cast<uint4*>(&ks[buf][0][swz(tid, half)]) =
          make_uint4(h[4 * half], h[4 * half + 1], h[4 * half + 2], h[4 * half + 3]);
      *reinterpret_cast<uint4*>(&ks[buf][1][swz(tid, half)]) =
          make_uint4(lo[4 * half], lo[4 * half + 1], lo[4 * half + 2], lo[4 * half + 3]);
    }
    const int p = pair_pos(tid);
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      split_tf32(vr[i], h[i], lo[i]);
      vs[buf][0][i * kVS + p] = __uint_as_float(h[i]);
      vs[buf][1][i * kVS + p] = __uint_as_float(lo[i]);
    }
  };

  // this thread's K and V row `row`: d == 8 by cp.async into `raw`, landed
  // and read by the same thread in stage(); else by plain loads there
  auto fetch = [&](int row) {
    if (d != kD) return;
    const bool in = row < s;
    const size_t off = static_cast<size_t>(in ? row : 0) * kD;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      cp_async<16>(&raw[0][tid * kD + 4 * u], k + off + 4 * u, in);
      cp_async<16>(&raw[1][tid * kD + 4 * u], v + off + 4 * u, in);
    }
    cp_async_commit();
  };
  auto stage = [&](int buf, int row) {
    float kr[kD], vr[kD];
    if (d == kD) {
      cp_async_wait<0>();
#pragma unroll
      for (int i = 0; i < kD; ++i) {
        kr[i] = raw[0][tid * kD + i];
        vr[i] = raw[1][tid * kD + i];
      }
    } else {
      load_row(k, row, s, d, kr);
      load_row(v, row, s, d, vr);
    }
    store_rows(buf, kr, vr);
  };

  const int tiles = (s + kKT - 1) / kKT;
  fetch(tid);
  stage(0, tid);
  for (int tile = 0; tile < tiles; ++tile) {
    const int j0 = tile * kKT;
    if (tile + 1 < tiles) fetch(j0 + kKT + tid);  // in flight during this tile
    __syncthreads();  // this tile stored; every warp done with the other buffer
    const float* kh = ks[tile & 1][0];
    const float* kl = ks[tile & 1][1];
    const float* vh = vs[tile & 1][0];
    const float* vl = vs[tile & 1][1];
    const int n = min(kKT, s - j0);  // valid keys in the tile; rows past it are 0

    for (int c0 = 0; c0 < n; c0 += kChunk) {  // every chunk has a valid key
      uint32_t kb[8][4];  // K^T B fragments {hi b0, hi b1, lo b0, lo b1} of each 8 keys
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) ldsm_x4(kb[nt], frag_rows(kh, kl, c0 + nt * 8, lane));
      const bool ragged = c0 + kChunk > n;

#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        float sc[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
          mma_tf32x3(sc[nt], qa[mt], kb[nt]);
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
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(sc[nt][2 * r], sc[nt][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mn = fmaxf(m[mt][r], mx);
          corr[r] = ex2(m[mt][r] - mn);  // 0 on the first chunk
          m[mt][r] = mn;
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            sc[nt][2 * r] = ex2(sc[nt][2 * r] - mn);  // 0 for masked keys
            sc[nt][2 * r + 1] = ex2(sc[nt][2 * r + 1] - mn);
            sum += sc[nt][2 * r] + sc[nt][2 * r + 1];
          }
          l[mt][r] = fmaf(l[mt][r], corr[r], sum);
        }
        // four accumulators: four chains of dependent products, not one
        float pv[4][4] = {};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          uint32_t vb[4], pa[2][4];
          ldsm_x4(vb, frag_cols(vh, vl, c0 + nt * 8, kVS, lane));
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(sc[nt][c2a(i)], pa[0][i], pa[1][i]);
          mma_tf32x3(pv[nt & 3], pa, vb);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float sum = (pv[0][i] + pv[1][i]) + (pv[2][i] + pv[3][i]);
          acc[mt][i] = fmaf(acc[mt][i], corr[i >> 1], sum);
        }
      }
    }
    if (tile + 1 < tiles) stage((tile + 1) & 1, j0 + kKT + tid);
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
        lse[static_cast<size_t>(blockIdx.x) * s + row] = m[mt][r] + log2f(lt);
      }
    }
  }
}

}  // namespace

// q, k, v, out: bh rows of (s, d) values, dtype 0 = fp32, 1 = bf16; lse:
// (bh, s) fp32, or null when no gradient is needed.
extern "C" int mdt_tinyhead_attention(const void* q, const void* k, const void* v, void* out,
                                      void* lse, int bh, int s, int d, float scale, int dtype,
                                      void* stream) {
  const int tiles = s > 0 ? (s + kRows - 1) / kRows : 0;
  if (bh <= 0 || s <= 0 || d <= 0 || d > kD || tiles > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(bh, tiles);
  const float c = scale * kLog2e;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    tinyhead_fwd_tf32_kernel<<<grid, kThreads, 0, st>>>(
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
