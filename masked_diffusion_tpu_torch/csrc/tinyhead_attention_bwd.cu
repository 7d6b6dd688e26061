// Exact softmax attention for tiny heads, backward: per (batch, head), from
// the forward's out and base-2 log-sum-exp lse (tinyhead_attention.cu) and
// the output gradient dO,
//
//   P_ij  = 2^(q_i k_j^T c - lse_i)      c = scale * log2 e
//   D_i   = sum_d dO_id O_id
//   dV_j  = sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i v_j^T - D_i)
//   dK_j  = scale sum_i dS_ij q_i,   dQ_i = scale sum_j dS_ij k_j
//
// with no (S, S) tensor in device memory. Replaces the gradient of the TPU
// kernel masked_diffusion_tpu/ops/pallas/tinyhead_attention.py: the custom
// VJP's _bwd (:168), which recomputes the forward with XLA einsums and
// materialises the (B, heads, S, S) scores.
//
// Bound. 10*S^2*D product operations per (b, h) and at least one
// exponential per score; as in the forward, the exponentials bound it (16 a
// clock per SM). This design takes two per score: it is deterministic, with
// no atomics, as two kernels launched back to back:
//   dkdv: a block of 4 warps owns 128 keys, a warp two 16-row tiles, its K
//         and V rows as mma A fragments; q, dO, lse and D stream through
//         shared memory in tiles of 128 queries (each thread fetches one
//         query's q, dO, O and lse for the next tile while the block computes;
//         D is summed from dO and O as the row is stored, so it needs no
//         pass of its own). Per chunk of 32 queries, transposed products:
//           S^T = K q^T, dP^T = V dO^T     mma.m16n8k8, q^T and dO^T by ldmatrix
//           P^T, dS^T                      one FFMA + ex2 and two FP32 ops a score
//           dV += P^T dO, dK += dS^T q      mma.m16n8k16, the score fragments
//                                           rounded in pairs to bf16 as A, dO
//                                           and q by ldmatrix.trans
//   dq:   the forward's layout: a warp owns 32 queries (q and dO fragments in
//         registers, lse and D per row, D summed in the lane's quad), K and V
//         stream through shared memory; per chunk of 32 keys S = q K^T and
//         dP = dO V^T (m16n8k8), P and dS, dQ += dS K (m16n8k16).
// The products are bf16 with fp32 accumulation; P and dS are rounded to bf16
// as the A operand of the second products, as the forward rounds P.
//
// fp32: the same two passes on the CUDA cores in fp32 (Hopper has no fp32
// tensor-core product without TF32), one thread per key (dkdv) or per query
// (dq), the other side's rows widened into shared memory 128 at a time.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tinyhead_mma.cuh"

namespace {

using tinyhead::kD;
using tinyhead::kLog2e;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMT = 2;                    // 16-row tiles per warp
constexpr int kRows = kWarps * kMT * 16;  // rows (keys or queries) per block
constexpr int kT = kThreads;              // streamed rows per shared tile: one per thread
constexpr int kChunk = 32;                // streamed rows per step
static_assert(kRows == kT, "a block owns as many rows as it streams per tile");

// ---- bf16: tensor cores -------------------------------------------------

__global__ void __launch_bounds__(kThreads, 4) tinyhead_bwd_dkdv_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
    const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dout,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int s, int d, float c,
    float scale) {
  using namespace tinyhead;
  __shared__ __align__(16) uint4 qs[2][kT];
  __shared__ __align__(16) uint4 dos[2][kT];
  __shared__ __align__(8) float ls[2][kT];
  __shared__ __align__(8) float dd[2][kT];

  const size_t head = static_cast<size_t>(blockIdx.x) * s * d;
  q += head;
  k += head;
  v += head;
  o += head;
  dout += head;
  dk += head;
  dv += head;
  lse += static_cast<size_t>(blockIdx.x) * s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = blockIdx.y * kRows + warp * kMT * 16;

  uint32_t ka[kMT][2], va[kMT][2];
  float dka[kMT][4], dva[kMT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ka[mt][r] = load_pair(k, key0 + mt * 16 + g + 8 * r, 2 * t, s, d);
      va[mt][r] = load_pair(v, key0 + mt * 16 + g + 8 * r, 2 * t, s, d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[mt][i] = dva[mt][i] = 0.f;
  }

  // one query row a thread: q, dO, O and lse in registers, then stored with
  // D = dO . O; rows past S get lse = +inf (P = 0) and zeros
  uint4 qr, dr, orow;
  float lr;
  auto fetch = [&](int i) {
    qr = load_row(q, i, s, d);
    dr = load_row(dout, i, s, d);
    orow = load_row(o, i, s, d);
    lr = i < s ? lse[i] : INFINITY;
  };
  auto stash = [&](int buf) {
    qs[buf][tid] = qr;
    dos[buf][tid] = dr;
    ls[buf][tid] = lr;
    dd[buf][tid] = dot_row(dr, orow);
  };

  const int tiles = (s + kT - 1) / kT;
  fetch(tid);
  stash(0);
  for (int tile = 0; tile < tiles; ++tile) {
    const int i0 = tile * kT;
    if (tile + 1 < tiles) fetch(i0 + kT + tid);
    __syncthreads();
    const int buf = tile & 1;
    const int n = min(kT, s - i0);
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      uint32_t qb[4], dob[4], qt[2][2], dot[2][2], r4[4];
      ldsm_x4(qb, qs[buf] + c0 + lane);
      ldsm_x4(dob, dos[buf] + c0 + lane);
      ldsm_x4_t(r4, qs[buf] + c0 + lane);
      qt[0][0] = r4[0]; qt[0][1] = r4[1]; qt[1][0] = r4[2]; qt[1][1] = r4[3];
      ldsm_x4_t(r4, dos[buf] + c0 + lane);
      dot[0][0] = r4[0]; dot[0][1] = r4[1]; dot[1][0] = r4[2]; dot[1][1] = r4[3];
      float2 lc[4], dc[4];  // lse and D of this lane's query columns
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        lc[nt] = *reinterpret_cast<const float2*>(&ls[buf][c0 + nt * 8 + 2 * t]);
        dc[nt] = *reinterpret_cast<const float2*>(&dd[buf][c0 + nt * 8 + 2 * t]);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        float st[4][4], dp[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) st[nt][i] = dp[nt][i] = 0.f;
          mma_k8(st[nt], ka[mt], qb[nt]);
          mma_k8(dp[nt], va[mt], dob[nt]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float li = (i & 1) ? lc[nt].y : lc[nt].x;
            const float di = (i & 1) ? dc[nt].y : dc[nt].x;
            const float p = ex2(fmaf(st[nt][i], c, -li));
            st[nt][i] = p;
            dp[nt][i] = p * (dp[nt][i] - di);
          }
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint32_t pa[4] = {
              pack_bf16(st[2 * kk][0], st[2 * kk][1]), pack_bf16(st[2 * kk][2], st[2 * kk][3]),
              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
          mma_k16(dva[mt], pa, dot[kk]);
          const uint32_t sa[4] = {
              pack_bf16(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
          mma_k16(dka[mt], sa, qt[kk]);
        }
      }
    }
    if (tile + 1 < tiles) stash((tile + 1) & 1);
  }

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = key0 + mt * 16 + g + 8 * r;
      store_pair(dk, row, 2 * t, s, d, dka[mt][2 * r] * scale, dka[mt][2 * r + 1] * scale);
      store_pair(dv, row, 2 * t, s, d, dva[mt][2 * r], dva[mt][2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4) tinyhead_bwd_dq_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
    const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dout,
    __nv_bfloat16* __restrict__ dq, int s, int d, float c, float scale) {
  using namespace tinyhead;
  __shared__ __align__(16) uint4 ks[2][kT];
  __shared__ __align__(16) uint4 vs[2][kT];

  const size_t head = static_cast<size_t>(blockIdx.x) * s * d;
  q += head;
  k += head;
  v += head;
  o += head;
  dout += head;
  dq += head;
  lse += static_cast<size_t>(blockIdx.x) * s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kRows + warp * kMT * 16;

  uint32_t qa[kMT][2], da[kMT][2];
  float lr[kMT][2], dr[kMT][2], acc[kMT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + mt * 16 + g + 8 * r;
      qa[mt][r] = load_pair(q, row, 2 * t, s, d);
      da[mt][r] = load_pair(dout, row, 2 * t, s, d);
      const uint32_t op = load_pair(o, row, 2 * t, s, d);
      float part = fmaf(lo_f32(da[mt][r]), lo_f32(op), hi_f32(da[mt][r]) * hi_f32(op));
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      dr[mt][r] = part;  // D of the row, summed over the quad's 4 pairs
      lr[mt][r] = row < s ? lse[row] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0.f;
  }

  const int tiles = (s + kT - 1) / kT;
  uint4 kr = load_row(k, tid, s, d), vr = load_row(v, tid, s, d);
  ks[0][tid] = kr;
  vs[0][tid] = vr;
  for (int tile = 0; tile < tiles; ++tile) {
    const int j0 = tile * kT;
    if (tile + 1 < tiles) {
      kr = load_row(k, j0 + kT + tid, s, d);
      vr = load_row(v, j0 + kT + tid, s, d);
    }
    __syncthreads();
    const uint4* kt = ks[tile & 1];
    const uint4* vt = vs[tile & 1];
    const int n = min(kT, s - j0);
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      uint32_t kb[4], vb[4], ktr[2][2], r4[4];
      ldsm_x4(kb, kt + c0 + lane);
      ldsm_x4(vb, vt + c0 + lane);
      ldsm_x4_t(r4, kt + c0 + lane);
      ktr[0][0] = r4[0]; ktr[0][1] = r4[1]; ktr[1][0] = r4[2]; ktr[1][1] = r4[3];
      const bool ragged = c0 + kChunk > n;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        float sc[4][4], dp[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[nt][i] = dp[nt][i] = 0.f;
          mma_k8(sc[nt], qa[mt], kb[nt]);
          mma_k8(dp[nt], da[mt], vb[nt]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float p = ex2(fmaf(sc[nt][i], c, -lr[mt][i >> 1]));
            if (ragged && c0 + nt * 8 + 2 * t + (i & 1) >= n) p = 0.f;  // keys past S
            dp[nt][i] = p * (dp[nt][i] - dr[mt][i >> 1]);
          }
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint32_t sa[4] = {
              pack_bf16(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
          mma_k16(acc[mt], sa, ktr[kk]);
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
      store_pair(dq, row0 + mt * 16 + g + 8 * r, 2 * t, s, d, acc[mt][2 * r] * scale,
                 acc[mt][2 * r + 1] * scale);
    }
  }
}

// ---- fp32: CUDA cores -----------------------------------------------------

// row i of an (s, d) fp32 matrix, zero-padded to 8, into shared memory
__device__ __forceinline__ void stage_row(float (*dst)[kD], int slot, const float* src, int i,
                                          int s, int d) {
#pragma unroll
  for (int c = 0; c < kD; ++c) {
    dst[slot][c] = (i < s && c < d) ? src[static_cast<size_t>(i) * d + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads) tinyhead_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ lse, const float* __restrict__ dout,
    float* __restrict__ dk, float* __restrict__ dv, int s, int d, float c, float scale) {
  __shared__ float qs[kT][kD];
  __shared__ float dos[kT][kD];
  __shared__ float ls[kT];
  __shared__ float dd[kT];

  const size_t head = static_cast<size_t>(blockIdx.x) * s * d;
  lse += static_cast<size_t>(blockIdx.x) * s;
  const int tid = threadIdx.x;
  const int j = blockIdx.y * kT + tid;
  const bool valid = j < s;
  float kr[kD], vr[kD], gk[kD], gv[kD];
#pragma unroll
  for (int e = 0; e < kD; ++e) {
    kr[e] = (valid && e < d) ? k[head + static_cast<size_t>(j) * d + e] : 0.f;
    vr[e] = (valid && e < d) ? v[head + static_cast<size_t>(j) * d + e] : 0.f;
    gk[e] = gv[e] = 0.f;
  }

  for (int i0 = 0; i0 < s; i0 += kT) {
    const int n = min(kT, s - i0);
    __syncthreads();  // every thread is done with the previous tile
    stage_row(qs, tid, q + head, i0 + tid, s, d);
    stage_row(dos, tid, dout + head, i0 + tid, s, d);
    float dsum = 0.f;
    for (int e = 0; e < d && tid < n; ++e) {
      dsum = fmaf(dos[tid][e], o[head + static_cast<size_t>(i0 + tid) * d + e], dsum);
    }
    dd[tid] = dsum;
    ls[tid] = tid < n ? lse[i0 + tid] : INFINITY;
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < kD; ++e) {
        sc = fmaf(kr[e], qs[i][e], sc);
        dp = fmaf(vr[e], dos[i][e], dp);
      }
      const float p = exp2f(fmaf(sc, c, -ls[i]));
      const float ds = p * (dp - dd[i]);
#pragma unroll
      for (int e = 0; e < kD; ++e) {
        gv[e] = fmaf(p, dos[i][e], gv[e]);
        gk[e] = fmaf(ds, qs[i][e], gk[e]);
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int e = 0; e < kD; ++e) {
      if (e < d) {
        dk[head + static_cast<size_t>(j) * d + e] = gk[e] * scale;
        dv[head + static_cast<size_t>(j) * d + e] = gv[e];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) tinyhead_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ lse, const float* __restrict__ dout,
    float* __restrict__ dq, int s, int d, float c, float scale) {
  __shared__ float ks[kT][kD];
  __shared__ float vs[kT][kD];

  const size_t head = static_cast<size_t>(blockIdx.x) * s * d;
  const int tid = threadIdx.x;
  const int i = blockIdx.y * kT + tid;
  const bool valid = i < s;
  float qr[kD], dr[kD], gq[kD];
  float dsum = 0.f;
#pragma unroll
  for (int e = 0; e < kD; ++e) {
    const size_t at = head + static_cast<size_t>(i) * d + e;
    qr[e] = (valid && e < d) ? q[at] : 0.f;
    dr[e] = (valid && e < d) ? dout[at] : 0.f;
    if (valid && e < d) dsum = fmaf(dr[e], o[at], dsum);
    gq[e] = 0.f;
  }
  const float li = valid ? lse[static_cast<size_t>(blockIdx.x) * s + i] : 0.f;

  for (int j0 = 0; j0 < s; j0 += kT) {
    const int n = min(kT, s - j0);
    __syncthreads();
    stage_row(ks, tid, k + head, j0 + tid, s, d);
    stage_row(vs, tid, v + head, j0 + tid, s, d);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < kD; ++e) {
        sc = fmaf(qr[e], ks[j][e], sc);
        dp = fmaf(dr[e], vs[j][e], dp);
      }
      const float ds = exp2f(fmaf(sc, c, -li)) * (dp - dsum);
#pragma unroll
      for (int e = 0; e < kD; ++e) gq[e] = fmaf(ds, ks[j][e], gq[e]);
    }
  }
  if (valid) {
#pragma unroll
    for (int e = 0; e < kD; ++e) {
      if (e < d) dq[head + static_cast<size_t>(i) * d + e] = gq[e] * scale;
    }
  }
}

}  // namespace

// q, k, v, out, dout, dq, dk, dv: bh rows of (s, d) values, dtype 0 = fp32,
// 1 = bf16; lse: (bh, s) fp32 from the forward. Launches dkdv, then dq.
extern "C" int mdt_tinyhead_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* out, const void* lse, const void* dout,
                                          void* dq, void* dk, void* dv, int bh, int s, int d,
                                          float scale, int dtype, void* stream) {
  const int tiles = s > 0 ? (s + kT - 1) / kT : 0;
  if (bh <= 0 || s <= 0 || d <= 0 || d > kD || tiles > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(bh, tiles);
  const float c = scale * kLog2e;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  if (dtype == 0) {
    const auto *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
               *vf = static_cast<const float*>(v), *of = static_cast<const float*>(out),
               *gf = static_cast<const float*>(dout);
    tinyhead_bwd_dkdv_kernel<<<grid, kThreads, 0, st>>>(qf, kf, vf, of, l, gf,
                                                        static_cast<float*>(dk),
                                                        static_cast<float*>(dv), s, d, c, scale);
    tinyhead_bwd_dq_kernel<<<grid, kThreads, 0, st>>>(qf, kf, vf, of, l, gf,
                                                      static_cast<float*>(dq), s, d, c, scale);
  } else {
    using bf = __nv_bfloat16;
    const auto *qb = static_cast<const bf*>(q), *kb = static_cast<const bf*>(k),
               *vb = static_cast<const bf*>(v), *ob = static_cast<const bf*>(out),
               *gb = static_cast<const bf*>(dout);
    tinyhead_bwd_dkdv_mma_kernel<<<grid, kThreads, 0, st>>>(
        qb, kb, vb, ob, l, gb, static_cast<bf*>(dk), static_cast<bf*>(dv), s, d, c, scale);
    tinyhead_bwd_dq_mma_kernel<<<grid, kThreads, 0, st>>>(qb, kb, vb, ob, l, gb,
                                                          static_cast<bf*>(dq), s, d, c, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
