// Fused degrade(t) + degrade(t-1) + update rule: one reverse sampling step's
// work after the UNet, in one kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel masked_diffusion_tpu/ops/pallas/fused_degrade.py:
// fused_degrade_update (pallas_call at :264, body _kernel :177, math
// fused_rows :112, exact_k_degrade :82, rowwise_kth_threshold :62). It
// computes exactly what fused_rows computes, per image:
//
//   bits_t, bits_n <- Philox4x32-10 at counter (pixel, image, (offset_hi <<
//                     1) | {0 for t, 1 for t-1}, offset_lo) keyed by the
//                     seed, or given bits (the tests' and the smoke check's
//                     path)
//   keep_t, keep_n <- thresholding: (bits >> 8) * 2^-24 > ratio
//                     indexing: not among the k smallest composite keys
//                     (low ceil(log2 HW) bits replaced by the pixel index, so
//                     keys are unique and the k-th smallest is a threshold
//                     that leaves exactly k below it), k >= HW degrading all
//   mu_t, mu_n     <- mean of x0 over degraded pixels (0 if none) or a const
//   D              =  keep ? x0 : mu
//   out            =  (x_t - D_t) + D_{t-1}   (base_momentum)
//                     D_{t-1}                 (base_sampling)
//   mask_next      =  keep_n as 0/1 floats
//
// Layout: rows of C*HW floats, channel-major (NCHW flattened per image);
// the 1-channel mask is shared by all channels.
//
// Bound: device-memory bytes. Per image it must read x_t and x0 once and
// write out and the mask: 3 * C * HW + HW floats, 9.4 MB at 64x64x3 and
// batch 64, ~2.8 us at 3.35 TB/s. The integer work, two Philox draws and
// one compare per key and selection, takes about half that at the card's
// integer rate (chip_smoke.py:fused_bound counts both). The one-CTA-per-image
// design this replaces filled only B of the 132 SMs, waited on 32
// block-wide reductions (64 barriers) before writing, and above 128x128
// re-read its keys from device memory on each of the 32 passes.
//
// Design (exact_k.cuh has the layout and the select):
// - A cluster of cs CTAs per image, cs from the host's plan
//   (ops/fused_degrade.py:exact_k_plan) so that batch * cs reaches a quarter
//   of the SM count: a serving batch of 16 spreads over 64 CTAs. Every HW up to
//   256 * 256 keeps its keys and keep bits in registers (at most 16 pixels
//   a thread); nothing but the outputs goes to device memory.
// - Indexing: both masks' selects run in the same rounds of an 8-bit radix
//   select, histograms summed across the cluster through distributed shared
//   memory, with the gather finish once the selected bins are small: 2
//   cluster barriers at 64x64 where the scan had 64 block barriers.
// - Masked means (degraded_area): each CTA's sums (x0 over degraded pixels
//   for t and t-1, and the counts) meet across the cluster in rank order, so
//   every CTA holds bitwise the same mu and a run repeats bitwise.
// - The means read x0 and the fills read it again, from L1/L2 (holding x0
//   and x_t in registers from the start measured no faster:
//   tools/exact_k_variants.py). The vector path moves a group of 4 pixels
//   as one float4 per channel (x_t, x0, out) and the mask as one float4;
//   ragged sizes (5x7, 45x45) take single pixels.

#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_launch.cuh"
#include "exact_k.cuh"

namespace {

using mdt::kMaxThreads;
using mdt::kMaxWarps;

enum Select { kThresholding = 0, kIndexing = 1 };
enum MeanMode { kConst = 0, kDegradedArea = 1 };
enum Rule { kBaseMomentum = 0, kBaseSampling = 1 };

struct FusedArgs {
  const float* xt;
  const float* x0;
  const float* amount_t;
  const float* amount_n;
  const uint32_t* bits;  // (2, batch, hw), or null: Philox
  uint64_t seed, offset;
  float* out;
  float* mask_n;
  int batch, channels, hw, select, mean_mode, rule;
  float mean_value;
  int cs, slice;
};

__device__ __forceinline__ bool keep_threshold(uint32_t bits, float ratio) {
  // top 24 bits, exact in f32: u uniform on [0, 1) at 2^-24 resolution
  const float u = __int2float_rn(static_cast<int>(bits >> 8)) * (1.0f / 16777216.0f);
  return u > ratio;
}

// One image's slice: P pixels a thread in groups of V.
template <int P, int V>
__global__ void __launch_bounds__(kMaxThreads) fused_degrade_kernel(const FusedArgs a) {
  __shared__ mdt::SelectSmem<2> sel;
  __shared__ float sums[kMaxWarps * 4 + 2 * 4];
  constexpr int G = P / V;  // groups a thread

  const int cs = a.cs, hw = a.hw, channels = a.channels;
  const int img = blockIdx.x / cs;
  const int start = (blockIdx.x % cs) * a.slice;
  const int end = min(hw, start + a.slice);
  const float at = a.amount_t[img];
  const float an = a.amount_n[img];
  const bool indexing = a.select == kIndexing;
  const bool momentum = a.rule == kBaseMomentum;
  const size_t base = static_cast<size_t>(img) * channels * hw;

  uint32_t valid = 0;  // bit i: key i of this thread is a pixel of the image
#pragma unroll
  for (int i = 0; i < P; ++i) valid |= static_cast<uint32_t>(mdt::pixel_of<V>(start, i) < end) << i;
  auto group_valid = [&](int g) { return ((valid >> (g * V)) & 1u) != 0; };
  auto elem = [&](int c, int g) {  // offset of group g's first pixel in channel c
    return base + static_cast<size_t>(c) * hw + mdt::pixel_of<V>(start, g * V);
  };

  // ---- draws -> keys (registers); keys[0] for t, keys[1] for t-1
  const uint32_t hi_mask = mdt::key_high_mask(hw);
  const uint32_t k0 = static_cast<uint32_t>(a.seed);
  const uint32_t k1 = static_cast<uint32_t>(a.seed >> 32);
  const uint32_t off_lo = static_cast<uint32_t>(a.offset);
  const uint32_t off_hi = static_cast<uint32_t>(a.offset >> 32);
  uint32_t keys[2][P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = mdt::pixel_of<V>(start, i);
    uint32_t bt = 0, bn = 0;
    if ((valid >> i) & 1u) {
      if (a.bits != nullptr) {
        bt = a.bits[static_cast<size_t>(img) * hw + p];
        bn = a.bits[(static_cast<size_t>(a.batch) + img) * hw + p];
      } else {
        bt = mdt::philox4x32_10_first(p, img, off_hi << 1, off_lo, k0, k1);
        bn = mdt::philox4x32_10_first(p, img, (off_hi << 1) | 1u, off_lo, k0, k1);
      }
      if (indexing) {
        bt = (bt & hi_mask) | static_cast<uint32_t>(p);
        bn = (bn & hi_mask) | static_cast<uint32_t>(p);
      }
    }
    keys[0][i] = bt;
    keys[1][i] = bn;
  }

  // ---- exact-k thresholds across the cluster (indexing)
  const int ks[2] = {static_cast<int>(at), static_cast<int>(an)};
  uint32_t thr[2] = {0, 0};
  if (indexing) mdt::radix_select<2, P>(keys, valid, ks, hw, thr, sel, cs);
  const bool all_t = ks[0] >= hw, all_n = ks[1] >= hw;

  // ---- keep bits
  uint32_t keep_t = 0, keep_n = 0;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    bool t_keep, n_keep;
    if (indexing) {
      t_keep = !(all_t || keys[0][i] < thr[0]);
      n_keep = !(all_n || keys[1][i] < thr[1]);
    } else {
      t_keep = keep_threshold(keys[0][i], at);
      n_keep = keep_threshold(keys[1][i], an);
    }
    keep_t |= static_cast<uint32_t>(t_keep) << i;
    keep_n |= static_cast<uint32_t>(n_keep) << i;
  }

  // ---- fills' means over degraded pixels (image-wise, all channels)
  float mu_t = a.mean_value, mu_n = a.mean_value;
  if (a.mean_mode == kDegradedArea) {
    float v[4] = {0.f, 0.f, static_cast<float>(__popc(~keep_t & valid)),
                  static_cast<float>(__popc(~keep_n & valid))};
#pragma unroll
    for (int c = 0; c < channels; ++c) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (!group_valid(g)) continue;
        float x[V];
        mdt::load<V>(a.x0 + elem(c, g), x);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const int i = g * V + u;
          if ((valid >> i) & 1u) {
            if (!((keep_t >> i) & 1u)) v[0] += x[u];
            if (!((keep_n >> i) & 1u)) v[1] += x[u];
          }
        }
      }
    }
    mdt::cluster_sum<4>(v, sums, cs);
    // counts are exact integers in f32: degraded pixels x channels
    const float cnt_t = v[2] * static_cast<float>(channels);
    const float cnt_n = v[3] * static_cast<float>(channels);
    mu_t = cnt_t > 0.f ? v[0] / fmaxf(cnt_t, 1.f) : 0.f;
    mu_n = cnt_n > 0.f ? v[1] / fmaxf(cnt_n, 1.f) : 0.f;
  }
  if (cs > 1) mdt::cluster_arrive();  // done reading the peers' shared memory

  // ---- fills, update rule, next mask
#pragma unroll
  for (int c = 0; c < channels; ++c) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (!group_valid(g)) continue;
      float x[V], xt[V], o[V];
      mdt::load<V>(a.x0 + elem(c, g), x);  // the second read of x0: from L1/L2
      if (momentum) mdt::load<V>(a.xt + elem(c, g), xt);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int i = g * V + u;
        const float d_t = ((keep_t >> i) & 1u) ? x[u] : mu_t;
        const float d_n = ((keep_n >> i) & 1u) ? x[u] : mu_n;
        o[u] = momentum ? (xt[u] - d_t) + d_n : d_n;
      }
      mdt::store<V>(a.out + elem(c, g), o);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (!group_valid(g)) continue;
    float m[V];
#pragma unroll
    for (int u = 0; u < V; ++u) m[u] = ((keep_n >> (g * V + u)) & 1u) ? 1.f : 0.f;
    mdt::store<V>(a.mask_n + static_cast<size_t>(img) * hw + mdt::pixel_of<V>(start, g * V),
                  m);
  }
  if (cs > 1) mdt::cluster_wait();  // no CTA leaves while a peer may read it
}

// The plan's kernel instance, or null.
const void* instance_of(const mdt::Plan& p) {
  return mdt::with_instance(p, static_cast<const void*>(nullptr), [](auto P, auto V) {
    return reinterpret_cast<const void*>(fused_degrade_kernel<decltype(P)::value,
                                                              decltype(V)::value>);
  });
}

}  // namespace

// x_t, x0, out: (batch, channels, hw) f32; amount_t, amount_n: (batch,) f32;
// bits: (2, batch, hw) u32 or null (Philox at seed, offset); mask_n: (batch,
// hw) f32. The plan (ops/fused_degrade.py:exact_k_plan): cs CTAs an image,
// threads a CTA, per_thread pixels a thread, vec the float4 path (every
// row pointer 16-byte aligned). A plan or mode the kernel does not take
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int mdt_fused_degrade(
    const void* xt, const void* x0, const void* amount_t, const void* amount_n,
    const void* bits, uint64_t seed, uint64_t offset, void* out, void* mask_n, int batch,
    int channels, int hw, int select, int mean_mode, float mean_value, int rule, int cs,
    int threads, int per_thread, int vec, void* stream) {
  const mdt::Plan p = {cs, threads, per_thread, vec};
  if (!mdt::plan_ok(p, batch, hw) || channels <= 0 || select < 0 || select > 1 ||
      mean_mode < 0 || mean_mode > 1 || rule < 0 || rule > 1 ||
      (vec && !(mdt::aligned16(xt) && mdt::aligned16(x0) && mdt::aligned16(out) &&
                mdt::aligned16(mask_n)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FusedArgs a;
  a.xt = static_cast<const float*>(xt);
  a.x0 = static_cast<const float*>(x0);
  a.amount_t = static_cast<const float*>(amount_t);
  a.amount_n = static_cast<const float*>(amount_n);
  a.bits = static_cast<const uint32_t*>(bits);
  a.seed = seed;
  a.offset = offset;
  a.out = static_cast<float*>(out);
  a.mask_n = static_cast<float*>(mask_n);
  a.batch = batch;
  a.channels = channels;
  a.hw = hw;
  a.select = select;
  a.mean_mode = mean_mode;
  a.rule = rule;
  a.mean_value = mean_value;
  a.cs = cs;
  a.slice = mdt::slice_of(hw, cs, vec ? 4 : 1);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(mdt::with_instance(p, cudaErrorInvalidValue, [&](auto P, auto V) {
    return mdt::launch_cluster<fused_degrade_kernel<decltype(P)::value, decltype(V)::value>>(
        batch * cs, threads, 0, cs, st, a);
  }));
}

// Resident clusters of the plan's kernel instance at cs CTAs of threads
// threads (0: the size cannot be scheduled on this card).
extern "C" int mdt_fused_degrade_max_clusters(int cs, int threads, int per_thread, int vec,
                                              int* out) {
  const void* fn = instance_of({cs, threads, per_thread, vec});
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(mdt::max_active_clusters(fn, 0, cs, threads, 0, out));
}

extern "C" const char* mdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
