// Shared pieces of the exact-k mask kernels (fused_degrade.cu, kmask.cu):
// the Philox draw, the block-wide sum, and the MSB-first bit-scan that finds
// exactly k degraded pixels per image.
//
// Both kernels run one block of kThreads threads per image; thread i owns the
// pixels i, i + kThreads, .... Up to kMaxHWRegs pixels (kMaxPerThread per
// thread) the keys live in registers. Above that, up to kMaxHW, 64 keys a
// thread fit neither in registers nor, at 256 KB an image, in a block's
// shared memory: the keys live in device memory (a scratch row the kernel
// fills, or the given bits, composed into keys as they are read) and each
// pass of the scan reads them back, from L2.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mdt {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 16;
constexpr int kMaxHWRegs = kThreads * kMaxPerThread;  // 128 * 128: keys in registers
constexpr int kMaxHW = 256 * 256;                     // keys in device memory above

// First 32-bit word of Philox4x32-10 at counter (c0, c1, c2, c3), key (k0, k1).
__device__ __forceinline__ uint32_t philox4x32_10_first(
    uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// Sum N values over the block; every thread gets the same totals, summed in
// the same order (so every thread takes the same branch on them).
template <typename T, int N>
__device__ __forceinline__ void block_sum(T (&v)[N], T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) scratch[i * kWarps + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T s = 0;
    for (int w = 0; w < kWarps; ++w) s += scratch[i * kWarps + w];
    v[i] = s;
  }
  __syncthreads();  // scratch may be reused by the next call
}

// Mask of the draw bits a composite key keeps: the low ceil(log2 hw) bits
// (at least one) are replaced by the pixel index, so keys are unique.
__device__ __forceinline__ uint32_t key_high_mask(int hw) {
  int lane_bits = hw > 1 ? 32 - __clz(hw - 1) : 0;
  if (lane_bits < 1) lane_bits = 1;
  return 0xFFFFFFFFu << lane_bits;
}

// N independent exact-k scans over the block's keys, fused into the same 32
// passes: thr[i] is the maximum T with count(key < T) <= k[i] over the hw
// valid pixels. With unique keys, (key < thr[i]) selects exactly
// min(max(k[i], 0), hw) pixels; k >= hw is left to the caller.
template <int J, int N>
__device__ __forceinline__ void exact_k_thresholds(
    const uint32_t (&keys)[N][J], const int (&k)[N], int hw, uint32_t (&thr)[N],
    int* scratch) {
#pragma unroll
  for (int i = 0; i < N; ++i) thr[i] = 0;
  for (int b = 31; b >= 0; --b) {
    uint32_t cand[N];
    int cnt[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      cand[i] = thr[i] | (1u << b);
      cnt[i] = 0;
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (static_cast<int>(threadIdx.x) + j * kThreads < hw) {
#pragma unroll
        for (int i = 0; i < N; ++i) cnt[i] += keys[i][j] < cand[i];
      }
    }
    block_sum<int, N>(cnt, scratch);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (cnt[i] <= k[i]) thr[i] = cand[i];
    }
  }
}

// One image's keys in device memory (the path above kMaxHWRegs): a row the
// kernel filled with keys, or a row of given draws whose low bits are
// replaced by the pixel index as they are read (compose).
struct KeyRow {
  const uint32_t* src;
  uint32_t hi_mask;
  bool compose;
  __device__ __forceinline__ uint32_t operator[](int p) const {
    const uint32_t b = src[p];
    return compose ? (b & hi_mask) | static_cast<uint32_t>(p) : b;
  }
};

// exact_k_thresholds over keys in device memory: the same 32 passes, each
// reading every key of the image once.
template <int N>
__device__ __forceinline__ void exact_k_thresholds_rows(
    const KeyRow (&rows)[N], const int (&k)[N], int hw, uint32_t (&thr)[N], int* scratch) {
#pragma unroll
  for (int i = 0; i < N; ++i) thr[i] = 0;
  for (int b = 31; b >= 0; --b) {
    uint32_t cand[N];
    int cnt[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      cand[i] = thr[i] | (1u << b);
      cnt[i] = 0;
    }
    for (int p = threadIdx.x; p < hw; p += kThreads) {
#pragma unroll
      for (int i = 0; i < N; ++i) cnt[i] += rows[i][p] < cand[i];
    }
    block_sum<int, N>(cnt, scratch);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (cnt[i] <= k[i]) thr[i] = cand[i];
    }
  }
}

}  // namespace mdt
