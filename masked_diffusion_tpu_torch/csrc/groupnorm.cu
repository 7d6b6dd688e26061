// GroupNorm (+ per-channel affine) (+ optional SiLU) over NCHW, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel masked_diffusion_tpu/ops/pallas/groupnorm.py:
// group_norm_silu (pallas_call at :113, body _gn_silu_kernel :55) and its
// custom VJP's backward (_bwd, :169, a jnp recompute on the TPU).
//
//   forward:  mean, var <- fp32 E[x], E[x^2] - E[x]^2 over each (image, group)
//             y <- (x - mean) * (rstd * gamma_c) + beta_c, then y * sigmoid(y)
//             with SiLU; written in x's dtype; fp32 mean and rstd saved when a
//             gradient will be taken (null pointers otherwise)
//   backward: x^ = (x - mean) * rstd; with SiLU y = gamma x^ + beta,
//             s = sigmoid(y), dy = g s (1 + y (1 - s)); without, dy = g
//             per channel: Sdy, Sdy*x^ (the (image, channel) parts of dbeta,
//             dgamma); m1 = sum_c gamma_c Sdy_c / n, m2 = sum_c gamma_c
//             Sdy*x^_c / n; dx = rstd (dy gamma - m1 - x^ m2)
//             dgamma, dbeta = the (image, channel) parts summed over images
//
// In NCHW one (image, group) is a span of n = C/G * H*W elements; with the
// H*W run of each channel contiguous the kernels take any image and channel
// strides (the attention block hands its norm a gradient whose channels are
// the fast axis, and that too is taken element by element).
//
// Bound: device-memory bytes. Forward: x read once, y written once; backward:
// x and g read once, dx written once, plus (B, C) fp32 parts. The design
// reads each span from device memory once:
//
// - Spans of more than 1024 elements (the cluster path): ctas CTAs per span,
//   a thread-block cluster when ctas > 1 (2 to 8, or 16 with the
//   non-portable size). Each CTA stages its contiguous slice of x (and g) in
//   shared memory as raw 16-byte words, four in flight per thread (two groups
//   of fp32), reducing as the values arrive; partial sums meet across the
//   cluster through distributed shared memory, read in rank order, so every
//   CTA of a cluster holds bitwise the same statistics. The second pass runs
//   from shared memory. A slice too large for shared memory (fp32 at
//   256x256, say) is read twice from device memory: the host's plan
//   (ops/groupnorm.py:gn_plan) says which. The backward's per-channel sums
//   give each channel of the slice its own warps.
// - Smaller spans (the warp path: the 8x8, 4x4 and 2x2 levels): one warp per
//   span, up to eight spans per CTA; one trip to device memory and no idle
//   warps. The forward holds the span in registers; the backward keeps dy
//   and x^ in shared memory, where neighbouring lanes sum each channel.
// - dgamma and dbeta inside the backward launch: each span writes its
//   per-channel parts to a (2, B, C) fp32 scratch; a per-group arrival counter
//   (atomicAdd after __threadfence) finds the last span of a group, which sums
//   the B parts in image order, writes dgamma and dbeta in the parameters'
//   dtype and resets the counter for the next call. One launch, no memset,
//   and the same inputs give bitwise the same dx, dgamma and dbeta.
//
// Split modes (parallel/sp.py: a span's rows lie on M ranks, whose sums
// meet in an all-reduce between two launches; mode 0 is the whole span):
//
//   forward, sums (1):  each span's fp32 Sx and Sx^2 over this rank's rows,
//                       written to sums (2, B*G); no y
//   forward, apply (2): mean = Sx / count, rstd = rsqrt(Sx^2 / count - mean^2
//                       + eps) from the all-reduced sums over the whole count
//                       (n * M), then y as the whole kernel writes it, and the
//                       statistics for the backward
//   backward, sums (1): from the saved global mean and rstd, the per-channel
//                       parts (dgamma and dbeta of this rank's rows, through
//                       the arrival counters as the whole kernel) and each
//                       span's m1 = sum_c gamma_c Sdy_c, m2 = sum_c gamma_c
//                       Sdy*x^_c, undivided, written to sums (2, B*G); no dx
//   backward, apply (2): dx from the all-reduced m1, m2 over the whole count
//
// The split passes stage nothing: the sums passes read each slice once,
// the apply passes once more (the all-reduce stands between them), so the
// forward pair moves 2 reads of x + 1 write of y and the backward pair 2
// reads of x and g + 1 write of dx. The sums passes take the whole call's
// path and combine a cluster's partials as the whole kernels do; the apply
// passes run the cluster path's kernels launched without a cluster, each
// CTA on its own slice, a CTA a span where the whole call takes the warp
// path: an apply pass in the warp kernels either unrolled fully (the
// backward's build 1.7x as long) or ran up to 4x slower.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "cluster_launch.cuh"

namespace cgrp = cooperative_groups;

namespace {

constexpr int kGroup = 8;       // elements per load group: 16 bytes of bf16, 32 of fp32
constexpr int kWarpSpans = 8;   // spans per CTA on the warp path, at most
constexpr int kParamLoads = 32; // loads in flight per thread summing dgamma, dbeta
constexpr int kMaxThreads = 512;
constexpr int kWhole = 0;  // modes: the whole span in one launch
constexpr int kSums = 1;   // split: this rank's partial sums only
constexpr int kApply = 2;  // split: the pass after the all-reduce of the sums
using mdt::kMaxSmem;

struct GnArgs {
  int batch, channels, hw, groups, cg, n;  // n = cg * hw, one span
  long long xsb, xsc, xsp;                 // x: image, channel, pixel strides (elements)
  long long gsb, gsc, gsp;                 // incoming gradient (backward)
  int ctas, slice, staged, tile_bytes;     // cluster path: CTAs per span, elements per CTA
  int silu, pdtype;                        // pdtype: scale/bias dtype, 0 fp32, 1 bf16, 2 fp16
  int x_vec, g_vec, out_vec;               // 16-byte groups allowed
  int mode;                                // kWhole, kSums or kApply
  float eps;
  float count;                             // kApply: elements of a span over all its ranks
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

__device__ __forceinline__ float ld_param(const void* p, int i, int pdtype) {
  if (pdtype == 0) return static_cast<const float*>(p)[i];
  if (pdtype == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return __half2float(static_cast<const __half*>(p)[i]);
}

__device__ __forceinline__ void st_param(void* p, int i, float v, int pdtype) {
  if (pdtype == 0) {
    static_cast<float*>(p)[i] = v;
  } else if (pdtype == 1) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  }
}

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// 1 / (1 + e^-v): ex2.approx and rcp.approx; e^-v = inf gives 0
__device__ __forceinline__ float sigmoid(float v) { return rcp_approx(1.f + __expf(-v)); }

// the gradient through SiLU at y, for the incoming g: g s (1 + y (1 - s))
__device__ __forceinline__ float silu_grad(float g, float y) {
  const float s = sigmoid(y);
  return g * s * fmaf(y, 1.f - s, 1.f);
}

// 8 values from a 16-byte aligned address
template <typename T>
__device__ __forceinline__ void ld8(const T* p, float (&v)[kGroup]) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) v[k] = to_f(e[k]);
  }
}

template <typename T>
__device__ __forceinline__ void st8(T* p, const float (&v)[kGroup]) {
  if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint4 r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) e[k] = from_f<T>(v[k]);
    *reinterpret_cast<uint4*>(p) = r;
  }
}

// One (image, group) span of a 4-D tensor with H*W flattened: element e is
// channel e / hw, pixel e % hw.
template <typename T>
struct Span {
  const T* base;  // element (image, group * cg, 0)
  int hw;
  long long sc, sp;
  bool contig;    // sp == 1 and sc == hw: the span is one run
  bool vec;       // contig, 16-byte aligned, hw % 8 == 0: groups load as vectors

  __device__ __forceinline__ float at(int e) const {
    if (contig) return to_f(base[e]);
    const int ch = e / hw;
    return to_f(base[ch * sc + static_cast<long long>(e - ch * hw) * sp]);
  }
  // the cnt (<= 8) values from e on; the rest of v is 0. Vector loads need
  // e % 8 == 0, which every caller keeps when vec is set.
  __device__ __forceinline__ void load(int e, int cnt, float (&v)[kGroup]) const {
    if (vec && cnt == kGroup) {
      ld8(base + e, v);
      return;
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) v[k] = k < cnt ? at(e + k) : 0.f;
  }
};

// A slice staged in shared memory, contiguous from slice-local index 0.
template <typename T>
__device__ __forceinline__ void tile_load(const T* tile, int i, int cnt, float (&v)[kGroup]) {
  if ((i & (kGroup - 1)) == 0 && cnt == kGroup) {
    ld8(tile + i, v);
    return;
  }
#pragma unroll
  for (int k = 0; k < kGroup; ++k) v[k] = k < cnt ? to_f(tile[i + k]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void tile_store(T* tile, int i, int cnt, const float (&v)[kGroup]) {
  if ((i & (kGroup - 1)) == 0 && cnt == kGroup) {
    st8(tile + i, v);
    return;
  }
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    if (k < cnt) tile[i + k] = from_f<T>(v[k]);
  }
}

// out: a contiguous span; e % 8 == 0 for the vector store
template <typename T>
__device__ __forceinline__ void out_store(T* out, bool vec, int e, int cnt,
                                          const float (&v)[kGroup]) {
  if (vec && cnt == kGroup) {
    st8(out + e, v);
    return;
  }
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    if (k < cnt) out[e + k] = from_f<T>(v[k]);
  }
}

// 8 elements as they lie in memory: one 16-byte word of 16-bit values, two
// of fp32
template <typename T>
struct Raw {
  uint4 q[sizeof(T) == 4 ? 2 : 1];
};

template <typename T>
__device__ __forceinline__ float raw_at(const Raw<T>& r, int k) {
  return to_f(reinterpret_cast<const T*>(r.q)[k]);
}

// Copies the slice [start, start + len) of a span to tile (when not null),
// kStage<T> 16-byte words in flight per thread; with Sums, adds the values
// and their squares to s and s2. Groups of 8 move as raw 16-byte words
// where the span allows it, element by element elsewhere.
template <typename T>
constexpr int kStage = sizeof(T) == 4 ? 2 : 4;  // groups per thread per round

template <typename T, bool Sums>
__device__ __forceinline__ void stage(T* tile, const Span<T>& src, int start, int len, float& s,
                                      float& s2) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int ngroups = (len + kGroup - 1) / kGroup;
  constexpr int U = kStage<T>;
  if (src.vec) {  // len is a multiple of 8 here
    for (int j0 = tid; j0 < ngroups; j0 += nthr * U) {
      Raw<T> r[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * nthr;
        if (j < ngroups) r[u] = *reinterpret_cast<const Raw<T>*>(src.base + start + j * kGroup);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * nthr;
        if (j < ngroups) {
          if (tile != nullptr) *reinterpret_cast<Raw<T>*>(tile + j * kGroup) = r[u];
          if (Sums) {
#pragma unroll
            for (int k = 0; k < kGroup; ++k) {
              const float v = raw_at(r[u], k);
              s += v;
              s2 += v * v;
            }
          }
        }
      }
    }
    return;
  }
  for (int j0 = tid; j0 < ngroups; j0 += nthr * U) {
    float v[U][kGroup];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * nthr;
      if (j < ngroups) src.load(start + j * kGroup, min(kGroup, len - j * kGroup), v[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * nthr;
      if (j < ngroups) {
        if (tile != nullptr) tile_store(tile, j * kGroup, min(kGroup, len - j * kGroup), v[u]);
        if (Sums) {
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            s += v[u][k];
            s2 += v[u][k] * v[u][k];
          }
        }
      }
    }
  }
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
  // butterfly: every lane ends with bitwise the same totals
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, m);
    b += __shfl_xor_sync(0xffffffffu, b, m);
  }
}

// Block-wide (a, b) totals in every thread, warps summed in order; wbuf holds
// 2 * 32 floats and is free again on return.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* wbuf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  warp_sum2(a, b);
  if (lane == 0) {
    wbuf[2 * warp] = a;
    wbuf[2 * warp + 1] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
  for (int w = 0; w < warps; ++w) {
    a += wbuf[2 * w];
    b += wbuf[2 * w + 1];
  }
  __syncthreads();
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The float region of the cluster path's shared memory, after the staged
// tiles: coef[2 cg] (gamma, beta), wpart[2 cg warps] (per channel, per warp),
// cpart[2 cg] (this CTA's per-channel parts), tot[2 cg] (the cluster's),
// wbuf[64], misc[4]. ops/groupnorm.py:_float_bytes mirrors the size.
__host__ __device__ constexpr int float_region(int cg, int warps) {
  return 2 * cg * (warps + 3) + 68;
}

// The last span of a group to finish sums the B per-image parts of its
// channels in image order into dgamma and dbeta, and resets the counter.
// Called by every thread of the finishing warp or CTA: thread t takes
// channel t % cg of dbeta (t < cg) or dgamma, kParamLoads loads in flight.
__device__ void reduce_params(const float* parts, void* dscale, void* dbias, int* counters,
                              const GnArgs& a, int grp, int tid, int nthr) {
  __threadfence();
  for (int t = tid; t < 2 * a.cg; t += nthr) {
    const int which = t / a.cg, c = grp * a.cg + t % a.cg;
    const float* p = parts + static_cast<size_t>(which) * a.batch * a.channels + c;
    float sum = 0.f;
    for (int i0 = 0; i0 < a.batch; i0 += kParamLoads) {
      float v[kParamLoads];
#pragma unroll
      for (int k = 0; k < kParamLoads; ++k) {
        v[k] = i0 + k < a.batch ? __ldcg(p + static_cast<size_t>(i0 + k) * a.channels) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kParamLoads; ++k) sum += v[k];
    }
    st_param(which ? dscale : dbias, c, sum, a.pdtype);
  }
  if (tid == 0) counters[grp] = 0;
}

// ------------------------------------------------------------------ forward

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2) gn_fwd_block_kernel(
    const T* __restrict__ x, const void* __restrict__ scale, const void* __restrict__ bias,
    T* __restrict__ y, float* __restrict__ mean_out, float* __restrict__ rstd_out,
    float* __restrict__ sums, GnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  float* coef = reinterpret_cast<float*>(smem + a.tile_bytes);
  float* wbuf = coef + 2 * a.cg * ((blockDim.x >> 5) + 3);
  float* part = wbuf + 64;

  const int span = blockIdx.x / a.ctas;  // image * groups + group
  const int rank = blockIdx.x % a.ctas;  // the CTA's rank in its cluster
  const int img = span / a.groups, grp = span % a.groups;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int start = rank * a.slice;
  const int len = max(0, min(a.slice, a.n - start));
  const int ngroups = (len + kGroup - 1) / kGroup;
  const Span<T> src{x + img * a.xsb + static_cast<long long>(grp) * a.cg * a.xsc, a.hw,
                    a.xsc, a.xsp, a.xsp == 1 && a.xsc == a.hw, a.x_vec != 0};

  if (a.mode != kSums) {
    for (int c = tid; c < a.cg; c += nthr) {  // gamma, beta of the group's channels
      coef[2 * c] = ld_param(scale, grp * a.cg + c, a.pdtype);
      coef[2 * c + 1] = ld_param(bias, grp * a.cg + c, a.pdtype);
    }
  }
  float mean, rstd;
  if (a.mode == kApply) {  // the statistics of the all-reduced sums
    const int spans = a.batch * a.groups;
    mean = sums[span] / a.count;
    rstd = rsqrtf(sums[spans + span] / a.count - mean * mean + a.eps);
    __syncthreads();  // coef before its reads
  } else {
    // one read of the slice: stage it (when it stays on chip) and reduce it
    float s = 0.f, s2 = 0.f;
    stage<T, true>(a.staged ? tile : nullptr, src, start, len, s, s2);
    block_sum2(s, s2, wbuf);  // also orders the staged tile and coef before their reads
    if (a.ctas > 1) {
      cgrp::cluster_group cluster = cgrp::this_cluster();
      if (tid == 0) {
        part[0] = s;
        part[1] = s2;
      }
      cluster.sync();
      float cs = 0.f, cs2 = 0.f;
      for (int r = 0; r < a.ctas; ++r) {
        const float* p = cluster.map_shared_rank(part, r);
        cs += p[0];
        cs2 += p[1];
      }
      s = cs;
      s2 = cs2;
      cluster_arrive();  // this CTA is done reading its peers
    }
    if (a.mode == kSums) {  // this rank's sums, for the all-reduce
      if (rank == 0 && tid == 0) {
        sums[span] = s;
        sums[a.batch * a.groups + span] = s2;
      }
      if (a.ctas > 1) cluster_wait();
      return;
    }
    const float inv_n = 1.f / static_cast<float>(a.n);
    mean = s * inv_n;
    rstd = rsqrtf(s2 * inv_n - mean * mean + a.eps);
  }
  if (rank == 0 && tid == 0 && mean_out != nullptr) {
    mean_out[span] = mean;
    rstd_out[span] = rstd;
  }

  T* out = y + static_cast<long long>(span) * a.n;
  const bool one_channel = a.hw % kGroup == 0;  // no group straddles two channels
#pragma unroll 2
  for (int j = tid; j < ngroups; j += nthr) {
    const int i = j * kGroup, cnt = min(kGroup, len - i);
    float v[kGroup];
    if (a.staged) {
      tile_load(tile, i, cnt, v);
    } else {
      src.load(start + i, cnt, v);
    }
    int ch = (start + i) / a.hw;
    if (one_channel) {
      const float sc = rstd * coef[2 * ch], bc = coef[2 * ch + 1];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        float o = (v[k] - mean) * sc + bc;
        if (a.silu) o *= sigmoid(o);
        v[k] = o;
      }
    } else {
      int r = start + i - ch * a.hw;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (r == a.hw) {
          ++ch;
          r = 0;
        }
        ++r;
        const int c = min(ch, a.cg - 1);
        float o = (v[k] - mean) * (rstd * coef[2 * c]) + coef[2 * c + 1];
        if (a.silu) o *= sigmoid(o);
        v[k] = o;
      }
    }
    out_store(out, a.out_vec != 0, start + i, cnt, v);
  }
  if (a.ctas > 1 && a.mode == kWhole) cluster_wait();  // no CTA leaves while a peer may read it
}

// The channel (within its group) of warp-path element e < 1024: exact, since
// (e + 0.5) / hw stays at least 0.5 / hw from an integer.
__device__ __forceinline__ int warp_channel(int e, float inv_hw, int cg) {
  return min(__float2int_rz((static_cast<float>(e) + 0.5f) * inv_hw), cg - 1);
}

// Floats of one warp-path array of V elements per lane, a pad word every 32
// (csrc and ops/groupnorm.py:gn_plan agree on it).
__host__ __device__ constexpr int warp_words(int v) { return 33 * v; }

template <typename T, int V>
__global__ void __launch_bounds__(32 * kWarpSpans) gn_fwd_warp_kernel(
    const T* __restrict__ x, const void* __restrict__ scale, const void* __restrict__ bias,
    T* __restrict__ y, float* __restrict__ mean_out, float* __restrict__ rstd_out,
    float* __restrict__ sums, GnArgs a) {
  const int lane = threadIdx.x & 31;
  const int span = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (span >= a.batch * a.groups) return;
  const int img = span / a.groups, grp = span % a.groups;
  const Span<T> src{x + img * a.xsb + static_cast<long long>(grp) * a.cg * a.xsc, a.hw,
                    a.xsc, a.xsp, a.xsp == 1 && a.xsc == a.hw, false};
  const bool lane_params = a.cg <= 32;  // lane c holds channel c's gamma and beta
  float gl = 0.f, bl = 0.f;
  if (lane_params && lane < a.cg && a.mode != kSums) {  // the sums pass takes no parameters
    gl = ld_param(scale, grp * a.cg + lane, a.pdtype);
    bl = ld_param(bias, grp * a.cg + lane, a.pdtype);
  }
  float v[V];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int e = j * 32 + lane;
    v[j] = e < a.n ? src.at(e) : 0.f;
    s += v[j];
    s2 += v[j] * v[j];
  }
  warp_sum2(s, s2);
  if (a.mode == kSums) {  // this rank's sums, for the all-reduce
    if (lane == 0) {
      sums[span] = s;
      sums[a.batch * a.groups + span] = s2;
    }
    return;
  }
  const float inv_n = 1.f / static_cast<float>(a.n);
  const float mean = s * inv_n;
  const float rstd = rsqrtf(s2 * inv_n - mean * mean + a.eps);
  if (lane == 0 && mean_out != nullptr) {
    mean_out[span] = mean;
    rstd_out[span] = rstd;
  }
  T* out = y + static_cast<long long>(span) * a.n;
  const float inv_hw = 1.f / static_cast<float>(a.hw);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int e = j * 32 + lane;
    const int c = warp_channel(e, inv_hw, a.cg);
    float gam, bet;
    if (lane_params) {
      gam = __shfl_sync(0xffffffffu, gl, c);
      bet = __shfl_sync(0xffffffffu, bl, c);
    } else {
      gam = ld_param(scale, grp * a.cg + c, a.pdtype);
      bet = ld_param(bias, grp * a.cg + c, a.pdtype);
    }
    float o = (v[j] - mean) * (rstd * gam) + bet;
    if (a.silu) o *= sigmoid(o);
    if (e < a.n) out[e] = from_f<T>(o);
  }
}

// ----------------------------------------------------------------- backward

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2) gn_bwd_block_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const void* __restrict__ scale,
    const void* __restrict__ bias, const float* __restrict__ mean_in,
    const float* __restrict__ rstd_in, T* __restrict__ dx, void* __restrict__ dscale,
    void* __restrict__ dbias, float* __restrict__ parts, int* __restrict__ counters,
    float* __restrict__ msums, GnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  T* tile_x = reinterpret_cast<T*>(smem);
  T* tile_g = reinterpret_cast<T*>(smem + a.tile_bytes / 2);
  float* coef = reinterpret_cast<float*>(smem + a.tile_bytes);
  float* wpart = coef + 2 * a.cg;
  float* cpart = wpart + 2 * a.cg * warps;
  float* tot = cpart + 2 * a.cg;
  float* misc = tot + 2 * a.cg + 64;

  const int span = blockIdx.x / a.ctas;
  const int rank = blockIdx.x % a.ctas;
  const int img = span / a.groups, grp = span % a.groups;
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int start = rank * a.slice;
  const int len = max(0, min(a.slice, a.n - start));
  const int ngroups = (len + kGroup - 1) / kGroup;
  const float mean = mean_in[span], rstd = rstd_in[span];
  const long long cbase = static_cast<long long>(grp) * a.cg;
  const Span<T> xs{x + img * a.xsb + cbase * a.xsc, a.hw, a.xsc, a.xsp,
                   a.xsp == 1 && a.xsc == a.hw, a.x_vec != 0};
  const Span<T> gs{g + img * a.gsb + cbase * a.gsc, a.hw, a.gsc, a.gsp,
                   a.gsp == 1 && a.gsc == a.hw, a.g_vec != 0};

  for (int c = tid; c < a.cg; c += nthr) {
    coef[2 * c] = ld_param(scale, grp * a.cg + c, a.pdtype);
    coef[2 * c + 1] = ld_param(bias, grp * a.cg + c, a.pdtype);
  }
  if (a.staged) {  // one read of x and of g
    float unused0 = 0.f, unused1 = 0.f;
    stage<T, false>(tile_x, xs, start, len, unused0, unused1);
    stage<T, false>(tile_g, gs, start, len, unused0, unused1);
  }
  __syncthreads();

  int last = 0;  // the arrival, issued before the dx pass and read after it
  if (a.mode == kApply) {  // m1, m2 from the all-reduced sums: no per-channel pass
    if (tid == 0) {
      misc[0] = msums[span] / a.count;
      misc[1] = msums[a.batch * a.groups + span] / a.count;
    }
    __syncthreads();
  } else {
    // per-channel sums of dy and dy * x^ over this slice: warps take channels,
    // `per` warps to a channel when the slice touches fewer channels than warps
    const int c_lo = len > 0 ? start / a.hw : 0;
    const int nch = len > 0 ? (start + len - 1) / a.hw - c_lo + 1 : 0;
    const int per = nch > 0 && nch < warps ? warps / nch : 1;
    const int q = warp % per;
    for (int cl = warp / per; cl < nch; cl += warps / per) {
      const int c = c_lo + cl;
      const int lo = max(c * a.hw, start) - start;
      const int hi = min((c + 1) * a.hw, start + len) - start;
      const float gam = coef[2 * c], bet = coef[2 * c + 1];
      float sdy = 0.f, sdyx = 0.f;
      for (int i = lo + (q * 32 + lane) * kGroup; i < hi; i += per * 32 * kGroup) {
        const int cnt = min(kGroup, hi - i);
        float vx[kGroup], vg[kGroup];
        if (a.staged) {
          tile_load(tile_x, i, cnt, vx);
          tile_load(tile_g, i, cnt, vg);
        } else {
          xs.load(start + i, cnt, vx);
          gs.load(start + i, cnt, vg);
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {  // padding: g = 0, so dy = 0
          const float xh = (vx[k] - mean) * rstd;
          const float dy = a.silu ? silu_grad(vg[k], xh * gam + bet) : vg[k];
          sdy += dy;
          sdyx += dy * xh;
        }
      }
      warp_sum2(sdy, sdyx);
      if (lane == 0) {
        wpart[2 * (cl * per + q)] = sdy;
        wpart[2 * (cl * per + q) + 1] = sdyx;
      }
    }
    __syncthreads();
    for (int c = tid; c < a.cg; c += nthr) {
      float sdy = 0.f, sdyx = 0.f;
      if (c >= c_lo && c < c_lo + nch) {
        for (int w = 0; w < per; ++w) {
          sdy += wpart[2 * ((c - c_lo) * per + w)];
          sdyx += wpart[2 * ((c - c_lo) * per + w) + 1];
        }
      }
      cpart[2 * c] = sdy;
      cpart[2 * c + 1] = sdyx;
    }
    const float* sums = cpart;
    if (a.ctas > 1) {
      cgrp::cluster_group cluster = cgrp::this_cluster();
      cluster.sync();
      for (int c = tid; c < a.cg; c += nthr) {
        float t0 = 0.f, t1 = 0.f;
        for (int r = 0; r < a.ctas; ++r) {
          const float* p = cluster.map_shared_rank(cpart, r);
          t0 += p[2 * c];
          t1 += p[2 * c + 1];
        }
        tot[2 * c] = t0;
        tot[2 * c + 1] = t1;
      }
      cluster_arrive();
      sums = tot;
    }
    __syncthreads();
    if (tid == 0) {
      float m1 = 0.f, m2 = 0.f;
      for (int c = 0; c < a.cg; ++c) {
        m1 += coef[2 * c] * sums[2 * c];
        m2 += coef[2 * c] * sums[2 * c + 1];
      }
      if (a.mode == kSums && rank == 0) {  // this rank's m1, m2, for the all-reduce
        msums[span] = m1;
        msums[a.batch * a.groups + span] = m2;
      }
      misc[0] = m1 / static_cast<float>(a.n);
      misc[1] = m2 / static_cast<float>(a.n);
    }
    if (rank == 0) {
      for (int c = tid; c < a.cg; c += nthr) {
        const size_t at = static_cast<size_t>(img) * a.channels + cbase + c;
        parts[at] = sums[2 * c];
        parts[static_cast<size_t>(a.batch) * a.channels + at] = sums[2 * c + 1];
      }
      if (tid < a.cg) __threadfence();  // the parts before the arrival below
    }
    __syncthreads();
    if (rank == 0 && tid == 0) last = atomicAdd(&counters[grp], 1) == a.batch - 1;
  }
  if (a.mode != kSums) {
    // dx = rstd (dy gamma - m1 - x^ m2) = dy (rstd gamma) - x^ (rstd m2) - rstd m1
    const float r2 = rstd * misc[1], k0 = -rstd * misc[0];

    T* out = dx + static_cast<long long>(span) * a.n;
    const bool one_channel = a.hw % kGroup == 0;
    for (int j = tid; j < ngroups; j += nthr) {
      const int i = j * kGroup, cnt = min(kGroup, len - i);
      float vx[kGroup], vg[kGroup];
      if (a.staged) {
        tile_load(tile_x, i, cnt, vx);
        tile_load(tile_g, i, cnt, vg);
      } else {
        xs.load(start + i, cnt, vx);
        gs.load(start + i, cnt, vg);
      }
      int ch = (start + i) / a.hw;
      int r = start + i - ch * a.hw;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (!one_channel) {
          if (r == a.hw) {
            ++ch;
            r = 0;
          }
          ++r;
        }
        const int c = min(ch, a.cg - 1);
        const float gam = coef[2 * c];
        const float xh = (vx[k] - mean) * rstd;
        const float dy = a.silu ? silu_grad(vg[k], xh * gam + coef[2 * c + 1]) : vg[k];
        vx[k] = fmaf(dy, rstd * gam, fmaf(-xh, r2, k0));
      }
      out_store(out, a.out_vec != 0, start + i, cnt, vx);
    }
  }

  if (a.mode != kApply) {
    if (rank == 0) {
      if (tid == 0) misc[2] = last ? 1.f : 0.f;
      __syncthreads();
      if (misc[2] != 0.f) reduce_params(parts, dscale, dbias, counters, a, grp, tid, nthr);
    }
    if (a.ctas > 1) cluster_wait();
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(32 * kWarpSpans) gn_bwd_warp_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const void* __restrict__ scale,
    const void* __restrict__ bias, const float* __restrict__ mean_in,
    const float* __restrict__ rstd_in, T* __restrict__ dx, void* __restrict__ dscale,
    void* __restrict__ dbias, float* __restrict__ parts, int* __restrict__ counters,
    float* __restrict__ msums, GnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int span = blockIdx.x * (blockDim.x >> 5) + warp;
  if (span >= a.batch * a.groups) return;
  // this warp's dy and x^, element e at e + e / 32 (a pad word every 32)
  float* s_dy = reinterpret_cast<float*>(smem) + warp * 2 * warp_words(V);
  float* s_xh = s_dy + warp_words(V);
  const int img = span / a.groups, grp = span % a.groups;
  const float mean = mean_in[span], rstd = rstd_in[span];
  const long long cbase = static_cast<long long>(grp) * a.cg;
  const Span<T> xs{x + img * a.xsb + cbase * a.xsc, a.hw, a.xsc, a.xsp,
                   a.xsp == 1 && a.xsc == a.hw, false};
  const Span<T> gs{g + img * a.gsb + cbase * a.gsc, a.hw, a.gsc, a.gsp,
                   a.gsp == 1 && a.gsc == a.hw, false};
  const bool lane_params = a.cg <= 32;  // lane c holds channel c's gamma and beta
  float gl = 0.f, bl = 0.f;
  if (lane_params && lane < a.cg) {
    gl = ld_param(scale, grp * a.cg + lane, a.pdtype);
    bl = ld_param(bias, grp * a.cg + lane, a.pdtype);
  }
  const float inv_hw = 1.f / static_cast<float>(a.hw);

  // one read of x and g; past the span g = 0, so dy = 0
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int e = j * 32 + lane;
    const float xv = e < a.n ? xs.at(e) : 0.f;
    const float gv = e < a.n ? gs.at(e) : 0.f;
    const int c = warp_channel(e, inv_hw, a.cg);
    float gam, bet;
    if (lane_params) {
      gam = __shfl_sync(kAll, gl, c);
      bet = __shfl_sync(kAll, bl, c);
    } else {
      gam = ld_param(scale, grp * a.cg + c, a.pdtype);
      bet = ld_param(bias, grp * a.cg + c, a.pdtype);
    }
    const float xh = (xv - mean) * rstd;
    s_dy[e + j] = a.silu ? silu_grad(gv, xh * gam + bet) : gv;
    s_xh[e + j] = xh;
  }
  __syncwarp();

  // per-channel sums S_c of dy and dy * x^: `lanes` neighbouring lanes to a
  // channel, each summing every lanes-th element of it, then a butterfly
  // among them; m1, m2 = sum_c gamma_c S_c
  const size_t row = static_cast<size_t>(img) * a.channels + cbase;
  float* pdb = parts + row;
  float* pdg = parts + static_cast<size_t>(a.batch) * a.channels + row;
  int lanes = 1;
  while (2 * lanes * a.cg <= 32) lanes *= 2;
  const int sub = lane & (lanes - 1);
  float m1 = 0.f, m2 = 0.f;
  for (int c0 = 0; c0 < a.cg; c0 += 32 / lanes) {
    const int c = c0 + lane / lanes;
    float s0 = 0.f, s1 = 0.f;
    if (c < a.cg) {
      for (int e = c * a.hw + sub; e < (c + 1) * a.hw; e += lanes) {
        const float d = s_dy[e + (e >> 5)];
        s0 += d;
        s1 += d * s_xh[e + (e >> 5)];
      }
    }
    for (int m = 1; m < lanes; m <<= 1) {
      s0 += __shfl_xor_sync(kAll, s0, m);
      s1 += __shfl_xor_sync(kAll, s1, m);
    }
    const int cc = min(c, a.cg - 1);
    const float gam = lane_params ? __shfl_sync(kAll, gl, cc)
                                  : ld_param(scale, grp * a.cg + cc, a.pdtype);
    if (sub == 0 && c < a.cg) {
      m1 += gam * s0;
      m2 += gam * s1;
      pdb[c] = s0;
      pdg[c] = s1;
    }
  }
  warp_sum2(m1, m2);
  __threadfence();  // this lane's parts before the arrival, issued now
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(&counters[grp], 1) == a.batch - 1;

  if (a.mode == kSums) {  // this rank's m1, m2, for the all-reduce; no dx
    if (lane == 0) {
      msums[span] = m1;
      msums[a.batch * a.groups + span] = m2;
    }
  } else {
    // dx = dy (rstd gamma) - x^ (rstd m2 / n) - rstd m1 / n
    const float r2 = rstd * m2 / static_cast<float>(a.n);
    const float k0 = -rstd * m1 / static_cast<float>(a.n);
    T* out = dx + static_cast<long long>(span) * a.n;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int e = j * 32 + lane;
      const int c = warp_channel(e, inv_hw, a.cg);
      const float gam = lane_params ? __shfl_sync(kAll, gl, c)
                                    : ld_param(scale, grp * a.cg + c, a.pdtype);
      const float v = fmaf(s_dy[e + j], rstd * gam, fmaf(-s_xh[e + j], r2, k0));
      if (e < a.n) out[e] = from_f<T>(v);
    }
  }
  last = __shfl_sync(kAll, last, 0);
  if (last) reduce_params(parts, dscale, dbias, counters, a, grp, lane, 32);
}

// ------------------------------------------------------------------- host

// Elements of a span per CTA: ceil(n / ctas) rounded up to a load group.
int slice_of(int n, int ctas) { return ((n + ctas - 1) / ctas + kGroup - 1) / kGroup * kGroup; }

int round16(long long bytes) { return static_cast<int>((bytes + 15) / 16 * 16); }

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Every instance launches through the shared cluster helper, allowed the
// full shared memory of a block.
template <auto Kernel, typename... Args>
cudaError_t launch(int grid, int threads, int smem, int ctas, cudaStream_t st, Args... args) {
  return mdt::launch_cluster<Kernel, kMaxSmem>(grid, threads, smem, ctas, st, args...);
}

// Fills the geometry of a and checks the host's plan against it; returns
// cudaErrorInvalidValue on a plan the kernels do not take.
cudaError_t setup(GnArgs& a, bool backward, int dsize, int per_lane, int threads, int smem) {
  if (a.batch <= 0 || a.channels <= 0 || a.hw <= 0 || a.groups <= 0 ||
      a.channels % a.groups != 0 || a.pdtype < 0 || a.pdtype > 2 || a.mode < kWhole ||
      a.mode > kApply || (a.mode == kApply && !(a.count > 0.f))) {
    return cudaErrorInvalidValue;
  }
  a.cg = a.channels / a.groups;
  const long long n = static_cast<long long>(a.cg) * a.hw;
  if (n > (1LL << 30)) return cudaErrorInvalidValue;
  a.n = static_cast<int>(n);
  if (per_lane > 0) {
    const int want = backward ? threads / 32 * 2 * warp_words(per_lane) * 4 : 0;
    if (32LL * per_lane < n || threads < 32 || threads > 32 * kWarpSpans || threads % 32 != 0 ||
        smem != want || a.ctas != 1 || a.mode == kApply) {  // apply: the cluster path's kernel
      return cudaErrorInvalidValue;
    }
    return cudaSuccess;
  }
  if (a.ctas < 1 || a.ctas > 16 || (a.ctas & (a.ctas - 1)) != 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || (a.mode != kWhole && a.staged)) {
    return cudaErrorInvalidValue;  // the cluster path's split passes stage nothing
  }
  a.slice = slice_of(a.n, a.ctas);
  const int tile = round16(static_cast<long long>(a.slice) * dsize);
  a.tile_bytes = a.staged ? (backward ? 2 * tile : tile) : 0;
  const int want = a.tile_bytes + 4 * float_region(a.cg, threads / 32);
  if (smem != want || smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T>
cudaError_t fwd(const void* x, const void* scale, const void* bias, void* y, void* mean,
                void* rstd, void* sums, GnArgs& a, int per_lane, int threads, int smem,
                cudaStream_t st) {
  cudaError_t err = setup(a, false, sizeof(T), per_lane, threads, smem);
  if (err != cudaSuccess) return err;
  if ((a.mode != kWhole) != (sums != nullptr) || (a.mode != kSums) != (y != nullptr)) {
    return cudaErrorInvalidValue;
  }
  a.x_vec = a.xsp == 1 && a.xsc == a.hw && a.hw % kGroup == 0 && aligned16(x) &&
            (a.xsb * static_cast<long long>(sizeof(T))) % 16 == 0;
  a.out_vec = aligned16(y) && a.n % kGroup == 0;
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  float* sp = static_cast<float*>(sums);
  const int spans = a.batch * a.groups;
  if (per_lane > 0) {
    const int grid = (spans + threads / 32 - 1) / (threads / 32);
    if (per_lane == 2) {
      return launch<gn_fwd_warp_kernel<T, 2>>(grid, threads, 0, 1, st, xp, scale, bias, yp,
                                                  mp, rp, sp, a);
    }
    if (per_lane == 8) {
      return launch<gn_fwd_warp_kernel<T, 8>>(grid, threads, 0, 1, st, xp, scale, bias, yp,
                                                  mp, rp, sp, a);
    }
    if (per_lane == 32) {
      return launch<gn_fwd_warp_kernel<T, 32>>(grid, threads, 0, 1, st, xp, scale, bias, yp,
                                                  mp, rp, sp, a);
    }
    return cudaErrorInvalidValue;
  }
  // the apply pass reads no peer: its CTAs launch without a cluster
  return launch<gn_fwd_block_kernel<T>>(spans * a.ctas, threads, smem,
                                        a.mode == kApply ? 1 : a.ctas, st, xp, scale, bias,
                                        yp, mp, rp, sp, a);
}

template <typename T>
cudaError_t bwd(const void* x, const void* g, const void* scale, const void* bias,
                const void* mean, const void* rstd, void* dx, void* dscale, void* dbias,
                void* parts, void* counters, void* sums, GnArgs& a, int per_lane, int threads,
                int smem, cudaStream_t st) {
  cudaError_t err = setup(a, true, sizeof(T), per_lane, threads, smem);
  if (err != cudaSuccess) return err;
  // dscale, dbias, parts and counters unless the apply pass; dx unless the sums pass
  const bool params = dscale != nullptr && dbias != nullptr && parts != nullptr &&
                      counters != nullptr;
  if ((a.mode != kWhole) != (sums != nullptr) || (a.mode != kApply) != params ||
      (a.mode != kSums) != (dx != nullptr)) {
    return cudaErrorInvalidValue;
  }
  const long long dsize = sizeof(T);
  a.x_vec = a.xsp == 1 && a.xsc == a.hw && a.hw % kGroup == 0 && aligned16(x) &&
            (a.xsb * dsize) % 16 == 0;
  a.g_vec = a.gsp == 1 && a.gsc == a.hw && a.hw % kGroup == 0 && aligned16(g) &&
            (a.gsb * dsize) % 16 == 0;
  a.out_vec = aligned16(dx) && a.n % kGroup == 0;
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(parts);
  int* cp = static_cast<int*>(counters);
  float* sp = static_cast<float*>(sums);
  const int spans = a.batch * a.groups;
  if (per_lane > 0) {
    const int grid = (spans + threads / 32 - 1) / (threads / 32);
    if (per_lane == 2) {
      return launch<gn_bwd_warp_kernel<T, 2>>(grid, threads, smem, 1, st, xp, gp, scale, bias,
                                                  mp, rp, dxp, dscale, dbias, pp, cp, sp, a);
    }
    if (per_lane == 8) {
      return launch<gn_bwd_warp_kernel<T, 8>>(grid, threads, smem, 1, st, xp, gp, scale, bias,
                                                  mp, rp, dxp, dscale, dbias, pp, cp, sp, a);
    }
    if (per_lane == 32) {
      return launch<gn_bwd_warp_kernel<T, 32>>(grid, threads, smem, 1, st, xp, gp, scale, bias,
                                                  mp, rp, dxp, dscale, dbias, pp, cp, sp, a);
    }
    return cudaErrorInvalidValue;
  }
  return launch<gn_bwd_block_kernel<T>>(spans * a.ctas, threads, smem,
                                        a.mode == kApply ? 1 : a.ctas, st, xp, gp, scale, bias,
                                        mp, rp, dxp, dscale, dbias, pp, cp, sp, a);
}

GnArgs make_args(int batch, int channels, int hw, int groups, long long xsb, long long xsc,
                 long long xsp, int ctas, int staged, int silu, int pdtype, float eps, int mode,
                 float count) {
  GnArgs a = {};
  a.batch = batch;
  a.channels = channels;
  a.hw = hw;
  a.groups = groups;
  a.xsb = xsb;
  a.xsc = xsc;
  a.xsp = xsp;
  a.ctas = ctas;
  a.staged = staged != 0;
  a.silu = silu != 0;
  a.pdtype = pdtype;
  a.eps = eps;
  a.mode = mode;
  a.count = count;
  return a;
}

// One dtype's work behind the C entry points: the arguments of
// mdt_group_norm_fwd / _bwd without the dtype.
#define MDT_GN_FWD_PARAMS                                                                    \
  const void *x, const void *scale, const void *bias, void *y, void *mean, void *rstd,       \
      int batch, int channels, int hw, int groups, long long xsb, long long xsc,             \
      long long xsp, float eps, int silu, int pdtype, int ctas, int per_lane, int threads,   \
      int smem, int staged, int mode, void *sums, float count, void *stream
#define MDT_GN_FWD_ARGS                                                                      \
  x, scale, bias, y, mean, rstd, batch, channels, hw, groups, xsb, xsc, xsp, eps, silu,      \
      pdtype, ctas, per_lane, threads, smem, staged, mode, sums, count, stream
#define MDT_GN_BWD_PARAMS                                                                    \
  const void *x, const void *g, const void *scale, const void *bias, const void *mean,       \
      const void *rstd, void *dx, void *dscale, void *dbias, void *parts, void *counters,    \
      int batch, int channels, int hw, int groups, long long xsb, long long xsc,             \
      long long xsp, long long gsb, long long gsc, long long gsp, int silu, int pdtype,      \
      int ctas, int per_lane, int threads, int smem, int staged, int mode, void *sums,       \
      float count, void *stream
#define MDT_GN_BWD_ARGS                                                                      \
  x, g, scale, bias, mean, rstd, dx, dscale, dbias, parts, counters, batch, channels, hw,    \
      groups, xsb, xsc, xsp, gsb, gsc, gsp, silu, pdtype, ctas, per_lane, threads, smem,     \
      staged, mode, sums, count, stream

template <typename T>
int fwd_entry(MDT_GN_FWD_PARAMS) {
  GnArgs a = make_args(batch, channels, hw, groups, xsb, xsc, xsp, ctas, staged, silu, pdtype,
                       eps, mode, count);
  if ((mean == nullptr) != (rstd == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fwd<T>(x, scale, bias, y, mean, rstd, sums, a, per_lane, threads,
                                 smem, static_cast<cudaStream_t>(stream)));
}

template <typename T>
int bwd_entry(MDT_GN_BWD_PARAMS) {
  GnArgs a = make_args(batch, channels, hw, groups, xsb, xsc, xsp, ctas, staged, silu, pdtype,
                       0.f, mode, count);
  a.gsb = gsb;
  a.gsc = gsc;
  a.gsp = gsp;
  return static_cast<int>(bwd<T>(x, g, scale, bias, mean, rstd, dx, dscale, dbias, parts,
                                 counters, sums, a, per_lane, threads, smem,
                                 static_cast<cudaStream_t>(stream)));
}

template <typename T, bool Backward>
int max_clusters_entry(int ctas, int threads, int smem, int* out) {
  const void* fn;
  if constexpr (Backward) {
    fn = reinterpret_cast<const void*>(gn_bwd_block_kernel<T>);
  } else {
    fn = reinterpret_cast<const void*>(gn_fwd_block_kernel<T>);
  }
  return static_cast<int>(mdt::max_active_clusters(fn, kMaxSmem, ctas, threads, smem, out));
}

}  // namespace

// The C entry points of dtype T, suffixed S: the forward's and the
// backward's. A template is compiled only where it is used, so each
// translation unit that expands one of these compiles one dtype's forward or
// backward kernels: this file the fp32 forward, groupnorm_bwd.cu the fp32
// backward, groupnorm_bf16[_bwd].cu and groupnorm_f16[_bwd].cu (which include
// this file) theirs, and the build runs the six nvcc processes at once.
#define MDT_GN_FWD_ENTRIES(T, S)                                                             \
  extern "C" int mdt_gn_fwd_##S(MDT_GN_FWD_PARAMS) { return fwd_entry<T>(MDT_GN_FWD_ARGS); } \
  extern "C" int mdt_gn_max_clusters_fwd_##S(int ctas, int threads, int smem, int* out) {    \
    return max_clusters_entry<T, false>(ctas, threads, smem, out);                           \
  }
#define MDT_GN_BWD_ENTRIES(T, S)                                                             \
  extern "C" int mdt_gn_bwd_##S(MDT_GN_BWD_PARAMS) { return bwd_entry<T>(MDT_GN_BWD_ARGS); } \
  extern "C" int mdt_gn_max_clusters_bwd_##S(int ctas, int threads, int smem, int* out) {    \
    return max_clusters_entry<T, true>(ctas, threads, smem, out);                            \
  }

#ifndef MDT_GN_ONE_DTYPE  // this file compiled on its own

MDT_GN_FWD_ENTRIES(float, f32)
#define MDT_GN_DECLARE(S)                                                                    \
  extern "C" int mdt_gn_fwd_##S(MDT_GN_FWD_PARAMS);                                          \
  extern "C" int mdt_gn_bwd_##S(MDT_GN_BWD_PARAMS);                                          \
  extern "C" int mdt_gn_max_clusters_fwd_##S(int ctas, int threads, int smem, int* out);     \
  extern "C" int mdt_gn_max_clusters_bwd_##S(int ctas, int threads, int smem, int* out);
MDT_GN_DECLARE(f32)
MDT_GN_DECLARE(bf16)
MDT_GN_DECLARE(f16)

// x: (batch, channels, hw) with strides (xsb, xsc, xsp) in elements; y: the
// same shape, contiguous; mean, rstd: (batch * groups) fp32, or null when no
// gradient will be taken. dtype / pdtype: 0 fp32, 1 bf16, 2 fp16 (x and y /
// scale and bias). The plan (ops/groupnorm.py:gn_plan): per_lane > 0 takes
// the warp path, else ctas CTAs per span with threads threads and smem bytes
// of dynamic shared memory, the slice staged when staged != 0. mode: 0 the
// whole span (sums null); 1 the split sums pass, which writes sums (2,
// batch * groups) fp32 and no y (null); 2 the split apply pass, which reads
// sums over count elements of a span. The split passes stage nothing.
extern "C" int mdt_group_norm_fwd(const void* x, const void* scale, const void* bias, void* y,
                                  void* mean, void* rstd, int batch, int channels, int hw,
                                  int groups, long long xsb, long long xsc, long long xsp,
                                  float eps, int silu, int dtype, int pdtype, int ctas,
                                  int per_lane, int threads, int smem, int staged, int mode,
                                  void* sums, float count, void* stream) {
  if (dtype == 0) return mdt_gn_fwd_f32(MDT_GN_FWD_ARGS);
  if (dtype == 1) return mdt_gn_fwd_bf16(MDT_GN_FWD_ARGS);
  if (dtype == 2) return mdt_gn_fwd_f16(MDT_GN_FWD_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
}

// g: the incoming gradient, strides (gsb, gsc, gsp); dx: contiguous, x's
// dtype; dscale, dbias: (channels,) in pdtype; parts: (2, batch, channels)
// fp32 scratch; counters: (groups,) int32, zero before the first call and
// left zero by every call. mode: 0 whole (sums null); 1 the split sums pass:
// dscale and dbias of these rows, m1 and m2 to sums (2, batch * groups), no
// dx (null); 2 the split apply pass: dx from sums over count elements of a
// span (dscale, dbias, parts and counters null).
extern "C" int mdt_group_norm_bwd(const void* x, const void* g, const void* scale,
                                  const void* bias, const void* mean, const void* rstd,
                                  void* dx, void* dscale, void* dbias, void* parts,
                                  void* counters, int batch, int channels, int hw, int groups,
                                  long long xsb, long long xsc, long long xsp, long long gsb,
                                  long long gsc, long long gsp, int silu, int dtype, int pdtype,
                                  int ctas, int per_lane, int threads, int smem, int staged,
                                  int mode, void* sums, float count, void* stream) {
  if (dtype == 0) return mdt_gn_bwd_f32(MDT_GN_BWD_ARGS);
  if (dtype == 1) return mdt_gn_bwd_bf16(MDT_GN_BWD_ARGS);
  if (dtype == 2) return mdt_gn_bwd_f16(MDT_GN_BWD_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of ctas CTAs (threads threads, smem bytes each) of the
// cluster-path kernel can be resident at once: 0 means the size cannot be
// scheduled on this card.
extern "C" int mdt_group_norm_max_clusters(int backward, int dtype, int ctas, int threads,
                                           int smem, int* out) {
  if (dtype == 0) {
    return backward ? mdt_gn_max_clusters_bwd_f32(ctas, threads, smem, out)
                    : mdt_gn_max_clusters_fwd_f32(ctas, threads, smem, out);
  }
  if (dtype == 1) {
    return backward ? mdt_gn_max_clusters_bwd_bf16(ctas, threads, smem, out)
                    : mdt_gn_max_clusters_fwd_bf16(ctas, threads, smem, out);
  }
  return backward ? mdt_gn_max_clusters_bwd_f16(ctas, threads, smem, out)
                  : mdt_gn_max_clusters_fwd_f16(ctas, threads, smem, out);
}

#endif  // MDT_GN_ONE_DTYPE
