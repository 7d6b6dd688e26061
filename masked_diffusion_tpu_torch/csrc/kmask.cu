// Exact-k random pixel masks: per image, a 1-channel keep-mask with exactly
// counts[i] zeros ("degraded" pixels), placed uniformly at random, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel masked_diffusion_tpu/ops/pallas/kmask.py:
// exact_count_masks_pallas (pallas_call at :103, body _kmask_kernel :57,
// greedy_kth_threshold :42), which the training step's indexing mode runs
// (masked_diffusion_tpu/ops/degrade.py:generate_masks :186-223).
//
//   draws  <- Philox4x32-10 at counter (pixel, image, 0x80000000 | offset_hi,
//             offset_lo) keyed by seed, or given bits (the tests' and the
//             smoke check's path); seed and offset come by value
//             (mdt_kmask) or from a device buffer (mdt_kmask_seeded), which
//             a CUDA graph's replays rewrite between launches
//   keys   <- each draw with its low ceil(log2 HW) bits replaced by the pixel
//             index: unique, so ties cannot shorten the count
//   mask   <- 0 where key < T, T the k-th smallest key (the maximum T with
//             count(key < T) <= k), 1 elsewhere; k >= HW degrades all,
//             k <= 0 none
//
// This is the exact-k law of masks_from_uniforms and of the fused degrade
// kernel, not the TPU kernel's `bits < T` on raw draws, which selects fewer
// than k pixels when draws tie at T (kmask.py:18-19). The counter's top bit
// keeps its stream apart from fused_degrade.cu's t / t-1 tags.
//
// Bound: integer operations. Per pixel one Philox draw and one compare
// (chip_smoke.py counts the draw's instructions from the compiled code); the
// mask written and the counts read are ~1 MB at 64x64 and batch 64, a
// third of the draws' time at 3.35 TB/s. The one-CTA-per-image design it
// replaces filled only B of the 132 SMs and waited on 32 block-wide
// reductions before the first store.
//
// Design (exact_k.cuh has the layout and the select): a cluster of cs CTAs
// per image from the host's plan (ops/fused_degrade.py:exact_k_plan), so
// the draws spread over at least a quarter of the SMs while each CTA keeps
// enough pixels to pay for the select's cluster barriers; keys in registers
// at every HW up to 256 * 256; the 8-bit radix select's rounds summed across
// the cluster through distributed shared memory, then its gather finish; the
// mask stored as one float4 a group of 4 pixels on the vector path, single
// floats on the ragged one. The TPU kernel's (8, HW/8) VMEM tiling and
// 1024-padding do not carry over.

#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_launch.cuh"
#include "exact_k.cuh"

namespace {

using mdt::kMaxThreads;

struct KmaskArgs {
  const int* counts;
  const uint32_t* bits;  // (batch, hw), or null: Philox
  uint64_t seed, offset;
  const uint64_t* seeds;  // {seed, offset} on the device, or null: the two above
  float* out;
  int hw, cs, slice;
};

template <int P, int V>
__global__ void __launch_bounds__(kMaxThreads) kmask_kernel(const KmaskArgs a) {
  __shared__ mdt::SelectSmem<1> sel;

  const int cs = a.cs, hw = a.hw;
  const int img = blockIdx.x / cs;
  const int start = (blockIdx.x % cs) * a.slice;
  const int end = min(hw, start + a.slice);
  const int k = a.counts[img];
  const uint32_t hi_mask = mdt::key_high_mask(hw);
  const uint64_t seed = a.seeds != nullptr ? a.seeds[0] : a.seed;
  const uint64_t offset = a.seeds != nullptr ? a.seeds[1] : a.offset;
  const uint32_t k0 = static_cast<uint32_t>(seed);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  const uint32_t off_lo = static_cast<uint32_t>(offset);
  const uint32_t tag = 0x80000000u | static_cast<uint32_t>(offset >> 32);

  uint32_t valid = 0;  // bit i: key i of this thread is a pixel of the image
  uint32_t keys[1][P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = mdt::pixel_of<V>(start, i);
    uint32_t key = 0;
    if (p < end) {
      valid |= 1u << i;
      const uint32_t b = a.bits != nullptr
                             ? a.bits[static_cast<size_t>(img) * hw + p]
                             : mdt::philox4x32_10_first(p, img, tag, off_lo, k0, k1);
      key = (b & hi_mask) | static_cast<uint32_t>(p);
    }
    keys[0][i] = key;
  }

  uint32_t thr[1];
  const int ks[1] = {k};
  mdt::radix_select<1, P>(keys, valid, ks, hw, thr, sel, cs);
  if (cs > 1) mdt::cluster_arrive();  // done reading the peers' shared memory

  const bool all = k >= hw;
  float* row = a.out + static_cast<size_t>(img) * hw;
#pragma unroll
  for (int g = 0; g < P / V; ++g) {
    if (!((valid >> (g * V)) & 1u)) continue;
    float m[V];
#pragma unroll
    for (int u = 0; u < V; ++u) m[u] = (all || keys[0][g * V + u] < thr[0]) ? 0.f : 1.f;
    mdt::store<V>(row + mdt::pixel_of<V>(start, g * V), m);
  }
  if (cs > 1) mdt::cluster_wait();  // no CTA leaves while a peer may read it
}

// The plan's kernel instance, or null.
const void* instance_of(const mdt::Plan& p) {
  return mdt::with_instance(p, static_cast<const void*>(nullptr), [](auto P, auto V) {
    return reinterpret_cast<const void*>(kmask_kernel<decltype(P)::value, decltype(V)::value>);
  });
}

int launch_kmask(const void* counts, const void* bits, uint64_t seed, uint64_t offset,
                 const void* seeds, void* out, int batch, int hw, int cs, int threads,
                 int per_thread, int vec, void* stream) {
  const mdt::Plan p = {cs, threads, per_thread, vec};
  if (!mdt::plan_ok(p, batch, hw) || (vec && !mdt::aligned16(out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KmaskArgs a;
  a.counts = static_cast<const int*>(counts);
  a.bits = static_cast<const uint32_t*>(bits);
  a.seed = seed;
  a.offset = offset;
  a.seeds = static_cast<const uint64_t*>(seeds);
  a.out = static_cast<float*>(out);
  a.hw = hw;
  a.cs = cs;
  a.slice = mdt::slice_of(hw, cs, vec ? 4 : 1);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(mdt::with_instance(p, cudaErrorInvalidValue, [&](auto P, auto V) {
    return mdt::launch_cluster<kmask_kernel<decltype(P)::value, decltype(V)::value>>(
        batch * cs, threads, 0, cs, st, a);
  }));
}

}  // namespace

// counts: (batch,) int32; bits: (batch, hw) u32 or null (Philox at seed,
// offset); out: (batch, hw) f32. The plan as mdt_fused_degrade's (out
// 16-byte aligned on the vector path); a plan the kernel does not take
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int mdt_kmask(const void* counts, const void* bits, uint64_t seed, uint64_t offset,
                         void* out, int batch, int hw, int cs, int threads, int per_thread,
                         int vec, void* stream) {
  return launch_kmask(counts, bits, seed, offset, nullptr, out, batch, hw, cs, threads,
                      per_thread, vec, stream);
}

// mdt_kmask with the Philox draws' seed and offset read by the kernel from
// seeds: two uint64 on the device, {seed, offset}. The masks are those of
// mdt_kmask at the same seed and offset, bit for bit; a CUDA graph that
// captured the launch draws anew whenever the buffer is rewritten.
extern "C" int mdt_kmask_seeded(const void* counts, const void* seeds, void* out, int batch,
                                int hw, int cs, int threads, int per_thread, int vec,
                                void* stream) {
  if (seeds == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_kmask(counts, nullptr, 0, 0, seeds, out, batch, hw, cs, threads, per_thread,
                      vec, stream);
}

// Resident clusters of the plan's kernel instance at cs CTAs of threads
// threads (0: the size cannot be scheduled on this card).
extern "C" int mdt_kmask_max_clusters(int cs, int threads, int per_thread, int vec, int* out) {
  const void* fn = instance_of({cs, threads, per_thread, vec});
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(mdt::max_active_clusters(fn, 0, cs, threads, 0, out));
}
