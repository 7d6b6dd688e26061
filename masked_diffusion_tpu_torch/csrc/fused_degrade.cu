// Fused degrade(t) + degrade(t-1) + update rule: one reverse sampling step's
// work after the UNet, in one kernel.
//
// Replaces the TPU kernel masked_diffusion_tpu/ops/pallas/fused_degrade.py:
// fused_degrade_update (pallas_call at :264, body _kernel :177, math
// fused_rows :112, exact_k_degrade :82, rowwise_kth_threshold :62). It
// computes exactly what fused_rows computes, per image:
//
//   bits_t, bits_n <- Philox4x32-10 at counter (pixel, image, t|t-1, offset),
//                     or given bits (the tests' and the smoke check's path)
//   keep_t, keep_n <- thresholding: (bits >> 8) * 2^-24 > ratio
//                     indexing: not among the k smallest composite keys
//                     (low ceil(log2 HW) bits replaced by the pixel index, so
//                     keys are unique and a 32-pass MSB-first bit-scan finds
//                     exactly k), with k >= HW degrading every pixel
//   mu_t, mu_n     <- mean of x0 over degraded pixels (0 if none) or a const
//   D              =  keep ? x0 : mu
//   out            =  (x_t - D_t) + D_{t-1}   (base_momentum)
//                     D_{t-1}                 (base_sampling)
//   mask_next      =  keep_n as 0/1 floats
//
// Layout: rows of C*HW floats, channel-major (NCHW flattened per image);
// the 1-channel mask is shared by all channels.
//
// Design. One block of 1024 threads per image; thread i owns pixels
// i, i+1024, .... Up to 128*128 (16 pixels a thread) it keeps their keys and
// keep bits in registers. The bit-scan's 32 passes each count candidates
// block-wide with a warp-shuffle reduction; the masked sums take one more.
// Above 128*128, up to the kernel's bound of 256*256, the keys of both masks
// live in device memory instead (fused_degrade_kernel_l2): the Philox route
// writes them to a (2, B, HW) scratch row once and each pass reads them back
// from L2 (2 x 256 KB an image at 256*256); given bits are read directly.
// Keep bits are recomputed from the keys where the means and fills need
// them. The 8-image blocking and the VMEM gate of the TPU kernel do not
// carry over.
//
// Bound: device-memory bytes. Per image per step it reads x_t and x0 once
// (x0's second read, for the fills, comes from L1/L2) and writes out: about
// 2 reads and 1 write of C*HW floats, plus HW floats of mask. At 64x64x3 and
// batch 64 that is ~9.4 MB, ~3 us at 3.35 TB/s. With one block an image, a
// batch of B images fills B of the 132 SMs, and each waits on 32 block-wide
// reductions (at 256*256, also on 32 reads of its keys from L2).

#include <cstdint>
#include <cuda_runtime.h>

#include "exact_k.cuh"

namespace {

using mdt::kMaxHW;
using mdt::kMaxHWRegs;
using mdt::kThreads;
using mdt::kWarps;

enum Select { kThresholding = 0, kIndexing = 1 };
enum MeanMode { kConst = 0, kDegradedArea = 1 };
enum Rule { kBaseMomentum = 0, kBaseSampling = 1 };

__device__ __forceinline__ bool keep_threshold(uint32_t bits, float ratio) {
  // top 24 bits, exact in f32: u uniform on [0, 1) at 2^-24 resolution
  const float u = __int2float_rn(static_cast<int>(bits >> 8)) * (1.0f / 16777216.0f);
  return u > ratio;
}

template <int J>
__global__ void __launch_bounds__(kThreads) fused_degrade_kernel(
    const float* __restrict__ xt, const float* __restrict__ x0,
    const float* __restrict__ amount_t, const float* __restrict__ amount_n,
    const uint32_t* __restrict__ bits, uint64_t seed, uint64_t offset,
    float* __restrict__ out, float* __restrict__ mask_n,
    int batch, int channels, int hw, int select, int mean_mode,
    float mean_value, int rule) {
  __shared__ int iscratch[2 * kWarps];
  __shared__ float fscratch[4 * kWarps];

  const int img = blockIdx.x;
  const int tid = threadIdx.x;
  const float at = amount_t[img];
  const float an = amount_n[img];
  const bool indexing = select == kIndexing;

  const uint32_t hi_mask = mdt::key_high_mask(hw);
  const uint32_t k0 = static_cast<uint32_t>(seed);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  const uint32_t off_lo = static_cast<uint32_t>(offset);
  const uint32_t off_hi = static_cast<uint32_t>(offset >> 32);

  // ---- draws -> keys (registers); keys[0] for t, keys[1] for t-1
  uint32_t keys[2][J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int p = tid + j * kThreads;
    uint32_t bt = 0xFFFFFFFFu, bn = 0xFFFFFFFFu;
    if (p < hw) {
      if (bits != nullptr) {
        bt = bits[static_cast<size_t>(img) * hw + p];
        bn = bits[(static_cast<size_t>(batch) + img) * hw + p];
      } else {
        bt = mdt::philox4x32_10_first(p, img, off_hi << 1, off_lo, k0, k1);
        bn = mdt::philox4x32_10_first(p, img, (off_hi << 1) | 1u, off_lo, k0, k1);
      }
      if (indexing) {
        bt = (bt & hi_mask) | static_cast<uint32_t>(p);
        bn = (bn & hi_mask) | static_cast<uint32_t>(p);
      }
    }
    keys[0][j] = bt;
    keys[1][j] = bn;
  }

  // ---- exact-k thresholds: max T with count(key < T) <= k, MSB first
  uint32_t thr[2] = {0, 0};
  const int kt = static_cast<int>(at);
  const int kn = static_cast<int>(an);
  if (indexing) {
    const int ks[2] = {kt, kn};
    mdt::exact_k_thresholds<J, 2>(keys, ks, hw, thr, iscratch);
  }
  const uint32_t thr_t = thr[0], thr_n = thr[1];

  // ---- keep bits
  uint32_t keep_t = 0, keep_n = 0;
  float deg[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (tid + j * kThreads < hw) {
      bool kt_keep, kn_keep;
      if (indexing) {
        kt_keep = !(keys[0][j] < thr_t || kt >= hw);
        kn_keep = !(keys[1][j] < thr_n || kn >= hw);
      } else {
        kt_keep = keep_threshold(keys[0][j], at);
        kn_keep = keep_threshold(keys[1][j], an);
      }
      keep_t |= static_cast<uint32_t>(kt_keep) << j;
      keep_n |= static_cast<uint32_t>(kn_keep) << j;
      deg[0] += kt_keep ? 0.f : 1.f;
      deg[1] += kn_keep ? 0.f : 1.f;
    }
  }

  const size_t base = static_cast<size_t>(img) * channels * hw;

  // ---- fills' means over degraded pixels (image-wise, all channels)
  float mu_t = mean_value, mu_n = mean_value;
  if (mean_mode == kDegradedArea) {
    float v[4] = {0.f, 0.f, deg[0], deg[1]};
    for (int c = 0; c < channels; ++c) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int p = tid + j * kThreads;
        if (p < hw) {
          const float x = x0[base + static_cast<size_t>(c) * hw + p];
          if (!((keep_t >> j) & 1u)) v[0] += x;
          if (!((keep_n >> j) & 1u)) v[1] += x;
        }
      }
    }
    mdt::block_sum<float, 4>(v, fscratch);
    // counts are exact integers in f32: degraded pixels x channels
    const float cnt_t = v[2] * static_cast<float>(channels);
    const float cnt_n = v[3] * static_cast<float>(channels);
    mu_t = cnt_t > 0.f ? v[0] / fmaxf(cnt_t, 1.f) : 0.f;
    mu_n = cnt_n > 0.f ? v[1] / fmaxf(cnt_n, 1.f) : 0.f;
  }

  // ---- fills, update rule, next mask
  for (int c = 0; c < channels; ++c) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int p = tid + j * kThreads;
      if (p < hw) {
        const size_t e = base + static_cast<size_t>(c) * hw + p;
        const float x = x0[e];
        const float d_t = ((keep_t >> j) & 1u) ? x : mu_t;
        const float d_n = ((keep_n >> j) & 1u) ? x : mu_n;
        out[e] = rule == kBaseMomentum ? (xt[e] - d_t) + d_n : d_n;
        if (c == 0) mask_n[static_cast<size_t>(img) * hw + p] = ((keep_n >> j) & 1u) ? 1.f : 0.f;
      }
    }
  }
}

// The path above kMaxHWRegs: the same computation with the keys in device
// memory (keys: a (2, batch, hw) scratch for the Philox route, unused when
// bits are given).
__global__ void __launch_bounds__(kThreads) fused_degrade_kernel_l2(
    const float* __restrict__ xt, const float* __restrict__ x0,
    const float* __restrict__ amount_t, const float* __restrict__ amount_n,
    const uint32_t* __restrict__ bits, uint64_t seed, uint64_t offset,
    float* __restrict__ out, float* __restrict__ mask_n, uint32_t* __restrict__ keys,
    int batch, int channels, int hw, int select, int mean_mode,
    float mean_value, int rule) {
  __shared__ int iscratch[2 * kWarps];
  __shared__ float fscratch[4 * kWarps];

  const int img = blockIdx.x;
  const int tid = threadIdx.x;
  const float at = amount_t[img];
  const float an = amount_n[img];
  const bool indexing = select == kIndexing;
  const uint32_t hi_mask = mdt::key_high_mask(hw);
  const size_t row_t = static_cast<size_t>(img) * hw;
  const size_t row_n = (static_cast<size_t>(batch) + img) * hw;

  // ---- draws -> keys (device memory); rows[0] for t, rows[1] for t-1
  mdt::KeyRow rows[2];
  if (bits != nullptr) {
    rows[0] = {bits + row_t, hi_mask, indexing};
    rows[1] = {bits + row_n, hi_mask, indexing};
  } else {
    const uint32_t k0 = static_cast<uint32_t>(seed);
    const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
    const uint32_t off_lo = static_cast<uint32_t>(offset);
    const uint32_t off_hi = static_cast<uint32_t>(offset >> 32);
    for (int p = tid; p < hw; p += kThreads) {
      uint32_t bt = mdt::philox4x32_10_first(p, img, off_hi << 1, off_lo, k0, k1);
      uint32_t bn = mdt::philox4x32_10_first(p, img, (off_hi << 1) | 1u, off_lo, k0, k1);
      if (indexing) {
        bt = (bt & hi_mask) | static_cast<uint32_t>(p);
        bn = (bn & hi_mask) | static_cast<uint32_t>(p);
      }
      keys[row_t + p] = bt;
      keys[row_n + p] = bn;
    }
    // each thread reads back only the keys it wrote
    rows[0] = {keys + row_t, hi_mask, false};
    rows[1] = {keys + row_n, hi_mask, false};
  }

  // ---- exact-k thresholds: max T with count(key < T) <= k, MSB first
  uint32_t thr[2] = {0, 0};
  const int kt = static_cast<int>(at);
  const int kn = static_cast<int>(an);
  if (indexing) {
    const int ks[2] = {kt, kn};
    mdt::exact_k_thresholds_rows<2>(rows, ks, hw, thr, iscratch);
  }
  auto keep_t = [&](int p) {
    return indexing ? !(rows[0][p] < thr[0] || kt >= hw) : keep_threshold(rows[0][p], at);
  };
  auto keep_n = [&](int p) {
    return indexing ? !(rows[1][p] < thr[1] || kn >= hw) : keep_threshold(rows[1][p], an);
  };

  const size_t base = static_cast<size_t>(img) * channels * hw;

  // ---- fills' means over degraded pixels (image-wise, all channels)
  float mu_t = mean_value, mu_n = mean_value;
  if (mean_mode == kDegradedArea) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p = tid; p < hw; p += kThreads) {
      const bool kt_keep = keep_t(p), kn_keep = keep_n(p);
      v[2] += kt_keep ? 0.f : 1.f;
      v[3] += kn_keep ? 0.f : 1.f;
      for (int c = 0; c < channels; ++c) {
        const float x = x0[base + static_cast<size_t>(c) * hw + p];
        if (!kt_keep) v[0] += x;
        if (!kn_keep) v[1] += x;
      }
    }
    mdt::block_sum<float, 4>(v, fscratch);
    // counts are exact integers in f32: degraded pixels x channels
    const float cnt_t = v[2] * static_cast<float>(channels);
    const float cnt_n = v[3] * static_cast<float>(channels);
    mu_t = cnt_t > 0.f ? v[0] / fmaxf(cnt_t, 1.f) : 0.f;
    mu_n = cnt_n > 0.f ? v[1] / fmaxf(cnt_n, 1.f) : 0.f;
  }

  // ---- fills, update rule, next mask
  for (int p = tid; p < hw; p += kThreads) {
    const bool kt_keep = keep_t(p), kn_keep = keep_n(p);
    for (int c = 0; c < channels; ++c) {
      const size_t e = base + static_cast<size_t>(c) * hw + p;
      const float x = x0[e];
      const float d_t = kt_keep ? x : mu_t;
      const float d_n = kn_keep ? x : mu_n;
      out[e] = rule == kBaseMomentum ? (xt[e] - d_t) + d_n : d_n;
    }
    mask_n[row_t + p] = kn_keep ? 1.f : 0.f;
  }
}

}  // namespace

extern "C" int mdt_fused_degrade(
    const void* xt, const void* x0, const void* amount_t, const void* amount_n,
    const void* bits, uint64_t seed, uint64_t offset, void* out, void* mask_n,
    void* keys, int batch, int channels, int hw, int select, int mean_mode,
    float mean_value, int rule, void* stream) {
  if (batch <= 0 || channels <= 0 || hw <= 0 || hw > kMaxHW ||
      (hw > kMaxHWRegs && bits == nullptr && keys == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* a = static_cast<const float*>(xt);
  const auto* b = static_cast<const float*>(x0);
  const auto* amt = static_cast<const float*>(amount_t);
  const auto* amn = static_cast<const float*>(amount_n);
  const auto* bb = static_cast<const uint32_t*>(bits);
  auto* o = static_cast<float*>(out);
  auto* m = static_cast<float*>(mask_n);
  auto s = static_cast<cudaStream_t>(stream);
  if (hw > kMaxHWRegs) {
    fused_degrade_kernel_l2<<<batch, kThreads, 0, s>>>(
        a, b, amt, amn, bb, seed, offset, o, m, static_cast<uint32_t*>(keys), batch,
        channels, hw, select, mean_mode, mean_value, rule);
    return static_cast<int>(cudaGetLastError());
  }
  const int per = (hw + kThreads - 1) / kThreads;
#define MDT_LAUNCH(J)                                                            \
  fused_degrade_kernel<J><<<batch, kThreads, 0, s>>>(                            \
      a, b, amt, amn, bb, seed, offset, o, m, batch, channels, hw, select,       \
      mean_mode, mean_value, rule)
  if (per <= 1) {
    MDT_LAUNCH(1);
  } else if (per <= 2) {
    MDT_LAUNCH(2);
  } else if (per <= 4) {
    MDT_LAUNCH(4);
  } else if (per <= 8) {
    MDT_LAUNCH(8);
  } else {
    MDT_LAUNCH(16);
  }
#undef MDT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
