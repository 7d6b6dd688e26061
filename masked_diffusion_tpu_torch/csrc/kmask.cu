// Exact-k random pixel masks: per image, a 1-channel keep-mask with exactly
// counts[i] zeros ("degraded" pixels), placed uniformly at random.
//
// Replaces the TPU kernel masked_diffusion_tpu/ops/pallas/kmask.py:
// exact_count_masks_pallas (pallas_call at :103, body _kmask_kernel :57,
// greedy_kth_threshold :42), which the training step's indexing mode runs
// (masked_diffusion_tpu/ops/degrade.py:generate_masks :186-223).
//
//   draws  <- Philox4x32-10 at counter (pixel, image, 0x80000000 | offset_hi,
//             offset_lo) keyed by seed, or given bits (the tests' and the
//             smoke check's path)
//   keys   <- each draw with its low ceil(log2 HW) bits replaced by the pixel
//             index: unique, so ties cannot shorten the count
//   mask   <- 0 where key < T, T the maximum with count(key < T) <= k (a
//             32-pass MSB-first bit-scan), 1 elsewhere; k >= HW degrades all,
//             k <= 0 none
//
// This is the exact-k law of masks_from_uniforms and of the fused degrade
// kernel, not the TPU kernel's `bits < T` on raw draws, which selects fewer
// than k pixels when draws tie at T (kmask.py:18-19). The counter's top bit
// keeps its stream apart from fused_degrade.cu's t / t-1 tags.
//
// Design. One block of 1024 threads per image, keys in registers up to
// 128 * 128 (16 per thread); the scan is the shared exact_k_thresholds of
// exact_k.cuh, one block-wide warp-shuffle count per pass. Above 128 * 128,
// up to the kernel's bound of 256 * 256, the keys live in device memory
// (kmask_kernel_l2): the Philox route writes them to a (B, HW) scratch row
// once and each of the 32 passes reads them back from L2 (256 KB an image
// at 256 * 256); given bits are read directly. The TPU kernel's (8, HW/8)
// VMEM tiling and 1024-padding do not carry over: padded threads simply
// hold no pixel.
//
// Bound: device-memory bytes, B*HW f32 of mask written (plus B*HW u32 read
// when bits are given): 1 MB at 64x64 and batch 64, ~0.3 us at 3.35 TB/s.
// The 32 passes are ~64 integer operations per pixel on top of Philox; the
// block-wide reductions, one block an image on 132 SMs, are what it waits on.

#include <cstdint>
#include <cuda_runtime.h>

#include "exact_k.cuh"

namespace {

using mdt::kMaxHW;
using mdt::kMaxHWRegs;
using mdt::kThreads;
using mdt::kWarps;

template <int J>
__global__ void __launch_bounds__(kThreads) kmask_kernel(
    const int* __restrict__ counts, const uint32_t* __restrict__ bits,
    uint64_t seed, uint64_t offset, float* __restrict__ out, int hw) {
  __shared__ int scratch[kWarps];

  const int img = blockIdx.x;
  const int tid = threadIdx.x;
  const int k = counts[img];
  const uint32_t hi_mask = mdt::key_high_mask(hw);
  const uint32_t k0 = static_cast<uint32_t>(seed);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  const uint32_t off_lo = static_cast<uint32_t>(offset);
  const uint32_t tag = 0x80000000u | static_cast<uint32_t>(offset >> 32);

  uint32_t keys[1][J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int p = tid + j * kThreads;
    uint32_t key = 0xFFFFFFFFu;
    if (p < hw) {
      const uint32_t b = bits != nullptr
                             ? bits[static_cast<size_t>(img) * hw + p]
                             : mdt::philox4x32_10_first(p, img, tag, off_lo, k0, k1);
      key = (b & hi_mask) | static_cast<uint32_t>(p);
    }
    keys[0][j] = key;
  }

  uint32_t thr[1];
  const int ks[1] = {k};
  mdt::exact_k_thresholds<J, 1>(keys, ks, hw, thr, scratch);

  const bool all = k >= hw;
  float* row = out + static_cast<size_t>(img) * hw;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int p = tid + j * kThreads;
    if (p < hw) row[p] = (all || keys[0][j] < thr[0]) ? 0.f : 1.f;
  }
}

// The path above kMaxHWRegs: the same masks with the keys in device memory
// (keys: a (batch, hw) scratch for the Philox route, unused when bits are
// given).
__global__ void __launch_bounds__(kThreads) kmask_kernel_l2(
    const int* __restrict__ counts, const uint32_t* __restrict__ bits,
    uint64_t seed, uint64_t offset, float* __restrict__ out,
    uint32_t* __restrict__ keys, int hw) {
  __shared__ int scratch[kWarps];

  const int img = blockIdx.x;
  const int k = counts[img];
  const uint32_t hi_mask = mdt::key_high_mask(hw);
  const size_t row = static_cast<size_t>(img) * hw;

  mdt::KeyRow rows[1];
  if (bits != nullptr) {
    rows[0] = {bits + row, hi_mask, true};
  } else {
    const uint32_t k0 = static_cast<uint32_t>(seed);
    const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
    const uint32_t off_lo = static_cast<uint32_t>(offset);
    const uint32_t tag = 0x80000000u | static_cast<uint32_t>(offset >> 32);
    for (int p = threadIdx.x; p < hw; p += kThreads) {
      const uint32_t b = mdt::philox4x32_10_first(p, img, tag, off_lo, k0, k1);
      keys[row + p] = (b & hi_mask) | static_cast<uint32_t>(p);
    }
    rows[0] = {keys + row, hi_mask, false};  // each thread reads back its own keys
  }

  uint32_t thr[1];
  const int ks[1] = {k};
  mdt::exact_k_thresholds_rows<1>(rows, ks, hw, thr, scratch);

  const bool all = k >= hw;
  for (int p = threadIdx.x; p < hw; p += kThreads) {
    out[row + p] = (all || rows[0][p] < thr[0]) ? 0.f : 1.f;
  }
}

}  // namespace

extern "C" int mdt_kmask(const void* counts, const void* bits, uint64_t seed,
                         uint64_t offset, void* out, void* keys, int batch, int hw,
                         void* stream) {
  if (batch <= 0 || hw <= 0 || hw > kMaxHW ||
      (hw > kMaxHWRegs && bits == nullptr && keys == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* c = static_cast<const int*>(counts);
  const auto* b = static_cast<const uint32_t*>(bits);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (hw > kMaxHWRegs) {
    kmask_kernel_l2<<<batch, kThreads, 0, s>>>(c, b, seed, offset, o,
                                                static_cast<uint32_t*>(keys), hw);
    return static_cast<int>(cudaGetLastError());
  }
  const int per = (hw + kThreads - 1) / kThreads;
#define MDT_LAUNCH(J) kmask_kernel<J><<<batch, kThreads, 0, s>>>(c, b, seed, offset, o, hw)
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
