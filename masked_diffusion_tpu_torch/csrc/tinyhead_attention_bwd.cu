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
// Bound. 10*S^2*D product operations per (b, h) and one exponential per
// score. With 8-wide heads the exponentials bound it: 16 ex2 a clock per SM
// on the special-function units against ~2000 bf16 tensor-core operations.
// So the bf16 kernel rebuilds every probability once, in one pass, and keeps
// the other work per score at one FFMA, one FMUL and one bf16 pack.
//
// bf16: tinyhead_bwd_mma_kernel, one pass over the scores. A CTA of 4 to 16
// warps owns a slice of one head's keys (ops/tinyhead_attention.py:
// tinyhead_bwd_plan: keys a CTA, slices a head, warps a CTA);
// a warp owns 64 keys (4 tiles of 16), the CTA's K and V rows sit in
// shared memory, and a slice wider than one pass (at most 1024 keys) runs
// as several. The CTA streams all of the head's queries in chunks of
// 64 (128 from 8 warps) through a ring of 4 stages in shared memory: q, dO
// and O rows of 16 bytes and lse by cp.async; the thread that copied a
// row's dO and O computes D = dO . O once, as soon as its copy lands, and
// stores -D as the C operand of the dP product. Per 16 queries and 16 keys,
// transposed products:
//   S^T = K q^T, dP^T - D = V dO^T - D   mma.m16n8k8, q^T and dO^T by ldmatrix
//   P^T, dS^T                            one FFMA + ex2, one FMUL a score
//   dV += P^T dO, dK += dS^T q            mma.m16n8k16: the score fragments
//                                         rounded in pairs to bf16 (cvt.rn) as
//                                         A; dO and q by ldmatrix.trans
//   dQ += dS K                            mma.m16n8k16: the rounded dS^T
//                                         fragments transposed in registers
//                                         (movmatrix), K by ldmatrix.trans
// P and dS are rounded to bf16 where they enter a product, as the forward
// rounds P and as tinyhead_backward_plain rounds them.
//
// Deterministic, with no atomics and no arrival counter. dK and dV sum in
// each warp's registers over the chunks in order. A warp's dQ part of a
// chunk (fp32) goes to shared memory; after the chunk's barrier the CTA sums
// the parts in warp order. One slice of one pass writes dQ itself, scaled
// and rounded once. Otherwise the CTA writes its fp32 sums to a workspace of
// (slices, B*heads, S, 8) (a later pass adds to what the same thread wrote
// in the pass before), and a second launch, tinyhead_bwd_dq_sum_kernel,
// sums the slices in index order, scales and rounds to bf16 once. Both are
// plain launches on the caller's stream, so the pair is safe under CUDA
// graph capture.
//
// fp32: two passes on the CUDA cores in fp32 (Hopper has no fp32
// tensor-core product without TF32), one thread per key (dkdv) or per query
// (dq), the other side's rows widened into shared memory 128 at a time; it
// rebuilds each probability twice.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "tinyhead_mma.cuh"

namespace {

using tinyhead::kD;
using tinyhead::kLog2e;

// ---- bf16: tensor cores, one pass ----------------------------------------

constexpr int kMT = 4;              // 16-key tiles a warp
constexpr int kWarpKeys = 16 * kMT;
constexpr int kMinWarps = 4;        // a thread a query row of a chunk, at least
constexpr int kMaxWarps = 16;
constexpr int kStages = 4;          // chunks in the cp.async ring
// queries a chunk (one barrier each): 128 for CTAs of 8 warps or more, else 64
constexpr int chunk_queries(int warps) { return warps >= 8 ? 128 : 64; }
static_assert(chunk_queries(kMinWarps) <= kMinWarps * 32, "a thread a query row of a chunk");

// registers a thread: one CTA of 16 warps an SM, or two of 8
constexpr int kRegs = 128;

template <int kC>
struct tinyhead_bwd_stage {
  uint4 q[kC];
  uint4 dout[kC];
  uint4 o[kC];
  float lse[kC];     // +inf past S (P = 0)
  float4 nd[kC / 2];  // -{D_2i, D_2i+1, D_2i, D_2i+1}: the dP^T product's C operand
};

// the ring, the pass's K and V rows, two chunks' dQ parts of every warp
template <int kC>
constexpr size_t smem_bytes(int warps) {
  return kStages * sizeof(tinyhead_bwd_stage<kC>) +
         2 * static_cast<size_t>(warps) * kWarpKeys * sizeof(uint4) +
         2 * static_cast<size_t>(warps) * kC * kD * sizeof(float);
}

// ldmatrix-layout 8 x 8 bf16 fragment transposed within the warp
__device__ __forceinline__ uint32_t movtrans(uint32_t x) {
  uint32_t y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// two 8 x 8 bf16 matrices transposed: lanes 0-15 give the addresses of rows 0-15
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const uint4* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
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

template <int kV>
struct Vec;  // kV fp32 values as one shared-memory access
template <>
struct Vec<1> {
  float x[1];
};
template <>
struct __align__(8) Vec<2> {
  float x[2];
};
template <>
struct __align__(16) Vec<4> {
  float x[4];
};

// kC: queries a chunk. kFull: d == 8, query rows copied by cp.async; else
// rows of d < 8 values zero-padded to 8 by plain loads
template <int kC, bool kFull>
__global__ void __maxnreg__(kRegs) tinyhead_bwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
    const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dout,
    __nv_bfloat16* __restrict__ dq, float* __restrict__ ws, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int bh, int s, int d, int keys_cta, int slices, float c,
    float scale) {
  using namespace tinyhead;
  constexpr int kPart = kC * kD;  // fp32 dQ values of a chunk
  using Stage = tinyhead_bwd_stage<kC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  Stage* ring = reinterpret_cast<Stage*>(smem);
  uint4* kvk = reinterpret_cast<uint4*>(ring + kStages);  // the pass's K rows
  uint4* kvv = kvk + warps * kWarpKeys;                     // and V rows
  float* part = reinterpret_cast<float*>(kvv + warps * kWarpKeys);  // [2][warps][kPart]

  const int head = blockIdx.x / slices, slice = blockIdx.x - head * slices;
  const size_t at = static_cast<size_t>(head) * s * d;  // the head's first value
  const size_t lat = static_cast<size_t>(head) * s;     // and its first lse
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int passes = keys_cta / (kWarpKeys * warps);
  const int chunks = (s + kC - 1) / kC;
  float* dst = ws ? ws + (static_cast<size_t>(slice) * bh + head) * s * kD : nullptr;

  // copies of chunk j into slot `slot`: thread r < kC a row's dO, O and
  // lse, then the next threads (or thread r again) a row's q
  auto stage = [&](int j, int slot) {
    Stage& st = ring[slot];
    for (int e = tid; e < 2 * kC; e += blockDim.x) {
      const int r = e & (kC - 1), row = j * kC + r;
      const bool in = row < s;
      const size_t off = at + static_cast<size_t>(in ? row : 0) * d;
      if (e < kC) {
        if constexpr (kFull) {
          cp_async<16>(&st.dout[r], dout + off, in);
          cp_async<16>(&st.o[r], o + off, in);
          cp_async<4>(&st.lse[r], lse + lat + (in ? row : 0), in);
        } else {
          st.dout[r] = load_row(dout + at, row, s, d);
          st.o[r] = load_row(o + at, row, s, d);
          st.lse[r] = in ? lse[lat + row] : 0.f;
        }
      } else if constexpr (kFull) {
        cp_async<16>(&st.q[r], q + off, in);
      } else {
        st.q[r] = load_row(q + at, row, s, d);
      }
    }
  };
  // D of a row of chunk j, by the thread that copied its dO and O, once its
  // copies have landed; rows past S get lse = +inf (P = 0) and D = 0
  auto finish = [&](int j, int slot) {
    if (tid < kC) {
      Stage& st = ring[slot];
      const int r = tid;
      const bool in = j * kC + r < s;
      const float nd = in ? -dot_row(st.dout[r], st.o[r]) : 0.f;
      float* pair = &st.nd[r >> 1].x;
      pair[r & 1] = pair[(r & 1) + 2] = nd;
      if (!in) st.lse[r] = INFINITY;
    }
  };
  // the CTA's dQ of chunk j: the warps' parts summed in warp order, kV
  // consecutive values a thread
  auto reduce = [&](int j, bool first, auto width) {
    constexpr int kV = decltype(width)::value;
    using V = Vec<kV>;
    const V* pb = reinterpret_cast<const V*>(part + (j & 1) * warps * kPart);
    for (int e = tid; e < kPart / kV; e += blockDim.x) {
      V acc = pb[e];
#pragma unroll 4
      for (int w = 1; w < warps; ++w) {
        const V x = pb[w * (kPart / kV) + e];
#pragma unroll
        for (int i = 0; i < kV; ++i) acc.x[i] += x.x[i];
      }
      const int row = j * kC + e * kV / kD, col = e * kV % kD;
      if (row >= s) continue;
      if (dst) {
        V* y = reinterpret_cast<V*>(dst + static_cast<size_t>(row) * kD + col);
        if (!first) {
          const V old = *y;
#pragma unroll
          for (int i = 0; i < kV; ++i) acc.x[i] += old.x[i];
        }
        *y = acc;
      } else {
#pragma unroll
        for (int i = 0; i < kV; ++i) {
          if (col + i < d) {
            dq[at + static_cast<size_t>(row) * d + col + i] =
                __float2bfloat16_rn(acc.x[i] * scale);
          }
        }
      }
    }
  };
  auto reduce_chunk = [&](int j, bool first) {  // 4, 2 or 1 values a thread
    if (kPart >= 4 * static_cast<int>(blockDim.x)) {
      reduce(j, first, std::integral_constant<int, 4>{});
    } else if (kPart >= 2 * static_cast<int>(blockDim.x)) {
      reduce(j, first, std::integral_constant<int, 2>{});
    } else {
      reduce(j, first, std::integral_constant<int, 1>{});
    }
  };

  for (int pass = 0; pass < passes; ++pass) {
    const int key0 = slice * keys_cta + pass * warps * kWarpKeys;  // the pass's first key
    const int wkey0 = key0 + warp * kWarpKeys;                     // this warp's
    const bool ragged = wkey0 + kWarpKeys > s;
    float dka[kMT][4], dva[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) dka[mt][i] = dva[mt][i] = 0.f;
    }
    if (pass > 0) __syncthreads();  // every thread done with the last pass's ring and rows
    for (int r = tid; r < warps * kWarpKeys; r += blockDim.x) {
      kvk[r] = load_row(k + at, key0 + r, s, d);
      kvv[r] = load_row(v + at, key0 + r, s, d);
    }

    // one chunk of kC queries against the warp's keys; the warp's dQ part of
    // the chunk to `mine`
    auto chunk = [&](const Stage& st, float* mine, auto masked) {
#pragma unroll
      for (int h = 0; h < kC / 16; ++h) {
        // lanes 0-15 address q rows, 16-31 dO rows of these 16 queries:
        // f = q^T, q^T, dO^T, dO^T B fragments of the two 8-query tiles;
        // ft = q and dO as B fragments over the 16 queries
        uint32_t f[4], ft[4];
        const uint4* rows = (lane < 16 ? st.q : st.dout) + h * 16 + (lane & 15);
        ldsm_x4(f, rows);
        ldsm_x4_t(ft, rows);
        const uint32_t qt[2] = {ft[0], ft[1]}, dot[2] = {ft[2], ft[3]};
        float2 ls[2];  // lse of this lane's two query columns, each 8-query tile
        float4 nd[2];  // and -D as the C operand of dP^T
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          ls[nt] = *reinterpret_cast<const float2*>(&st.lse[h * 16 + nt * 8 + 2 * t]);
          nd[nt] = st.nd[h * 8 + nt * 4 + t];
        }
        float dqa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          // K and V of the tile's 16 keys as A fragments (lanes 0-15 address
          // K rows, 16-31 V rows), K as the B fragment of dS K
          const int tile = warp * kWarpKeys + mt * 16 + (lane & 15);
          uint32_t kva[4], kb[2];
          ldsm_x4(kva, (lane < 16 ? kvk : kvv) + tile);
          ldsm_x2_t(kb, kvk + tile);
          const uint32_t ka[2] = {kva[0], kva[1]}, va[2] = {kva[2], kva[3]};
          // P^T and dS^T as A fragments (16 keys x 16 queries), rounded to
          // bf16 an 8-query tile at a time
          uint32_t pa[4], sa[4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            // dP^T - D: the product accumulates onto -D
            float sc[4] = {0.f, 0.f, 0.f, 0.f};
            float dp[4] = {nd[nt].x, nd[nt].y, nd[nt].z, nd[nt].w};
            mma_k8(sc, ka, f[nt]);
            mma_k8(dp, va, f[2 + nt]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float p = ex2(fmaf(sc[i], c, (i & 1) ? -ls[nt].y : -ls[nt].x));
              if constexpr (decltype(masked)::value) {
                if (wkey0 + mt * 16 + g + 8 * (i >> 1) >= s) p = 0.f;  // keys past S
              }
              sc[i] = p;
              dp[i] *= p;
            }
            pa[2 * nt] = pack_bf16(sc[0], sc[1]);
            pa[2 * nt + 1] = pack_bf16(sc[2], sc[3]);
            sa[2 * nt] = pack_bf16(dp[0], dp[1]);
            sa[2 * nt + 1] = pack_bf16(dp[2], dp[3]);
          }
          mma_k16(dva[mt], pa, dot);
          mma_k16(dka[mt], sa, qt);
          // dS (16 queries x 16 keys): sa's 8 x 8 blocks transposed
          const uint32_t da[4] = {movtrans(sa[0]), movtrans(sa[2]), movtrans(sa[1]),
                                  movtrans(sa[3])};
          mma_k16(dqa, da, kb);
        }
        // this warp's dQ part of queries h*16 + g and h*16 + g + 8
        *reinterpret_cast<float2*>(&mine[(h * 16 + g) * kD + 2 * t]) = make_float2(dqa[0], dqa[1]);
        *reinterpret_cast<float2*>(&mine[(h * 16 + g + 8) * kD + 2 * t]) =
            make_float2(dqa[2], dqa[3]);
      }
    };

#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
      if (j < chunks) stage(j, j);
      cp_async_commit();
    }
    cp_async_wait<kStages - 2>();
    finish(0, 0);
    for (int j = 0; j < chunks; ++j) {
      // chunk j and its D (and the pass's K and V rows) visible; chunk j - 1's
      // compute done: its slot free, its parts written
      __syncthreads();
      if (j + kStages - 1 < chunks) stage(j + kStages - 1, (j + kStages - 1) % kStages);
      cp_async_commit();
      float* mine = part + ((j & 1) * warps + warp) * kPart;
      if (ragged) {  // a warp with keys past S: their P set to 0
        chunk(ring[j % kStages], mine, std::true_type{});
      } else {
        chunk(ring[j % kStages], mine, std::false_type{});
      }
      // after its own compute, while other warps still compute: chunk j - 1's
      // sums, then chunk j + 1's D once this thread's copies of it landed
      if (j > 0) reduce_chunk(j - 1, pass == 0);
      cp_async_wait<kStages - 2>();
      if (j + 1 < chunks) finish(j + 1, (j + 1) % kStages);
    }
    __syncthreads();
    reduce_chunk(chunks - 1, pass == 0);

#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wkey0 + mt * 16 + g + 8 * r;
        store_pair(dk + at, row, 2 * t, s, d, dka[mt][2 * r] * scale,
                   dka[mt][2 * r + 1] * scale);
        store_pair(dv + at, row, 2 * t, s, d, dva[mt][2 * r], dva[mt][2 * r + 1]);
      }
    }
  }
}

// dq = bf16(scale * sum over slices of ws), the slices in index order; one
// thread a row of (B*heads*S, d)
__global__ void __launch_bounds__(256) tinyhead_bwd_dq_sum_kernel(const float* __restrict__ ws,
                                                                  __nv_bfloat16* __restrict__ dq,
                                                                  int rows, int slices, int d,
                                                                  float scale) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const float4* p = reinterpret_cast<const float4*>(ws) + static_cast<size_t>(row) * 2;
  float4 a = p[0], b = p[1];
  for (int sl = 1; sl < slices; ++sl) {
    const float4* x = p + static_cast<size_t>(sl) * rows * 2;
    const float4 xa = x[0], xb = x[1];
    a.x += xa.x; a.y += xa.y; a.z += xa.z; a.w += xa.w;
    b.x += xb.x; b.y += xb.y; b.z += xb.z; b.w += xb.w;
  }
  const float r[kD] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  __nv_bfloat16* out = dq + static_cast<size_t>(row) * d;
  if (d == kD) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = tinyhead::pack_bf16(r[2 * i] * scale, r[2 * i + 1] * scale);
    *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int i = 0; i < d; ++i) out[i] = __float2bfloat16_rn(r[i] * scale);
  }
}

// the plan as the kernel takes it (ops/tinyhead_attention.py:tinyhead_bwd_plan):
// 4 to 16 warps, a whole number of passes, every key in one slice and no
// slice empty, and a workspace exactly when dQ has parts to sum
bool bwd_plan_ok(int s, int keys_cta, int slices, int warps, bool has_ws) {
  if (warps < kMinWarps || warps > kMaxWarps || slices < 1 || keys_cta <= 0 ||
      keys_cta % (kWarpKeys * warps) != 0) {
    return false;
  }
  if (static_cast<long long>(slices) * keys_cta < s ||
      static_cast<long long>(slices - 1) * keys_cta >= s) {
    return false;
  }
  const bool parts = slices > 1 || keys_cta > kWarpKeys * warps;
  return parts == has_ws;
}

template <int kC, bool kFull>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const void* out,
                           const float* lse, const void* dout, void* dq, float* ws, void* dk,
                           void* dv, int bh, int s, int d, int keys_cta, int slices, int warps,
                           float c, float scale, cudaStream_t st) {
  using bf = __nv_bfloat16;
  auto kernel = tinyhead_bwd_mma_kernel<kC, kFull>;
  const size_t smem = smem_bytes<kC>(warps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<bh * slices, warps * 32, smem, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(out), lse, static_cast<const bf*>(dout), static_cast<bf*>(dq), ws,
      static_cast<bf*>(dk), static_cast<bf*>(dv), bh, s, d, keys_cta, slices, c, scale);
  return cudaGetLastError();
}

// ---- fp32: CUDA cores -----------------------------------------------------

constexpr int kThreads = 128;
constexpr int kT = kThreads;  // streamed rows per shared tile: one per thread

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
// 1 = bf16; lse: (bh, s) fp32 from the forward. bf16: the one-pass kernel on
// the plan (keys_cta, slices, warps), then, when ws is given ((slices, bh,
// s, 8) fp32, for a plan with more than one slice or pass), the slice sum;
// a plan the kernel does not take returns cudaErrorInvalidValue. fp32: the
// plan is not read (pass 0s and no ws); dkdv, then dq.
extern "C" int mdt_tinyhead_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* out, const void* lse, const void* dout,
                                          void* dq, void* dk, void* dv, void* ws, int bh, int s,
                                          int d, float scale, int dtype, int keys_cta,
                                          int slices, int warps, void* stream) {
  if (bh <= 0 || s <= 0 || d <= 0 || d > kD || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float c = scale * kLog2e;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  if (dtype == 0) {
    const int tiles = (s + kT - 1) / kT;
    if (tiles > 65535 || ws != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(bh, tiles);
    const auto *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
               *vf = static_cast<const float*>(v), *of = static_cast<const float*>(out),
               *gf = static_cast<const float*>(dout);
    tinyhead_bwd_dkdv_kernel<<<grid, kThreads, 0, st>>>(qf, kf, vf, of, l, gf,
                                                        static_cast<float*>(dk),
                                                        static_cast<float*>(dv), s, d, c, scale);
    tinyhead_bwd_dq_kernel<<<grid, kThreads, 0, st>>>(qf, kf, vf, of, l, gf,
                                                      static_cast<float*>(dq), s, d, c, scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (!bwd_plan_ok(s, keys_cta, slices, warps, ws != nullptr) ||
      static_cast<long long>(bh) * slices > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* w = static_cast<float*>(ws);
  auto launch = chunk_queries(warps) == 128
                     ? (d == kD ? launch_bwd_mma<128, true> : launch_bwd_mma<128, false>)
                     : (d == kD ? launch_bwd_mma<64, true> : launch_bwd_mma<64, false>);
  cudaError_t err = launch(q, k, v, out, l, dout, dq, w, dk, dv, bh, s, d, keys_cta, slices,
                           warps, c, scale, st);
  if (err != cudaSuccess || w == nullptr) return static_cast<int>(err);
  const int rows = bh * s;
  tinyhead_bwd_dq_sum_kernel<<<(rows + 255) / 256, 256, 0, st>>>(
      w, static_cast<__nv_bfloat16*>(dq), rows, slices, d, scale);
  return static_cast<int>(cudaGetLastError());
}
