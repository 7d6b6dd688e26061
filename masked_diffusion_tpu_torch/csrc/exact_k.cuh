// Shared pieces of the exact-k mask kernels (fused_degrade.cu, kmask.cu): the
// Philox draw, the composite keys, the launch plan and its check, the
// cluster-wide sums, and the radix select that finds exactly k degraded
// pixels per image.
//
// Layout. A cluster of cs CTAs serves one image (cs = 1: a lone CTA; the
// grid is batch * cs CTAs, image blockIdx.x / cs, rank blockIdx.x % cs).
// Rank q owns the contiguous slice [q * slice, min(hw, (q + 1) * slice)) of
// the image's pixels, slice = ceil(hw / cs) rounded up to V. Thread t holds
// P pixels (P <= 16) in registers, in groups of V neighbours: group g starts
// at pixel q * slice + V * (t + g * threads). V = 4 is the vector path
// (hw % 4 == 0 and every row 16-byte aligned: one float4 per group and
// channel), V = 1 the ragged path. The host's plan
// (ops/fused_degrade.py:exact_k_plan) picks cs, threads, P and V; plan_ok
// is the check the entry points make before a launch.
//
// Select. For 0 <= k < hw the k-th smallest key (0-indexed) is the maximum T
// with count(key < T) <= k, the threshold of the scan the plain version and
// the TPU kernel run, so (key < T) picks the same pixels. An 8-bit digit
// radix select finds it, most significant digit first (an 11-bit digit
// would take 3 rounds of 2048-bin sums; not measured). Round r histograms
// digit r of the keys whose higher digits equal the prefix found so far, in
// each CTA's shared memory (double-buffered by round parity, so a CTA may
// start the next round while a peer still reads this one); after a cluster
// barrier every CTA sums the cs histograms through distributed shared
// memory in rank order (integers: exact and the same in every CTA); every
// warp scans the 256 sums for the digit d with below(d) <= k_rem <
// below(d) + hist(d), appends d and subtracts below(d). Once the selected
// bin holds at most kGather keys over the cluster (after round 0 at 64x64,
// round 1 at 256x256, for the draws' uniform keys) the gather finish ranks
// them directly: two cluster barriers in all at 64x64 where the 32-pass
// scan had 64 block barriers. k >= hw (degrade all) and k < 0 (none) take
// no select.

#pragma once

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace mdt {

namespace cg = cooperative_groups;

constexpr int kMaxHW = 256 * 256;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxPerThread = 16;
constexpr int kMaxCluster = 16;
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr int kRounds = 32 / kDigitBits;
constexpr int kGather = 64;  // candidates at most for the gather finish

// The launch plan: cs CTAs an image, threads a CTA, per_thread pixels a
// thread, vec: groups of 4 pixels moved as float4 (else single pixels).
struct Plan {
  int cs, threads, per_thread, vec;
};

// Pixels of an image a CTA owns: ceil(hw / cs) rounded up to v.
__host__ __device__ inline int slice_of(int hw, int cs, int v) {
  const int per = (hw + cs - 1) / cs;
  return (per + v - 1) / v * v;
}

inline bool pow2_upto(int x, int hi) { return x >= 1 && x <= hi && (x & (x - 1)) == 0; }

inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The plans the kernels take (ops/fused_degrade.py:exact_k_plan_ok mirrors
// it): cs and per_thread powers of 2 up to 16, whole warps up to 512
// threads, the vector path only where hw % 4 == 0 and a thread holds a
// group, and the CTA's threads covering its slice.
inline bool plan_ok(const Plan& p, int batch, int hw) {
  if (batch <= 0 || hw <= 0 || hw > kMaxHW || !pow2_upto(p.cs, kMaxCluster) ||
      !pow2_upto(p.per_thread, kMaxPerThread) || p.threads < 32 || p.threads > kMaxThreads ||
      p.threads % 32 != 0 || (p.vec != 0 && p.vec != 1) || batch > INT_MAX / p.cs) {
    return false;
  }
  if (p.vec && (hw % 4 != 0 || p.per_thread < 4)) return false;
  return p.threads * p.per_thread >= slice_of(hw, p.cs, p.vec ? 4 : 1);
}

// f(std::integral_constant<int, P>, std::integral_constant<int, V>) for the
// plan's kernel instance, P pixels a thread in groups of V; none where the
// plan names no instance.
template <typename R, typename F>
R with_instance(const Plan& p, R none, F f) {
  using I1 = std::integral_constant<int, 1>;
  using I2 = std::integral_constant<int, 2>;
  using I4 = std::integral_constant<int, 4>;
  using I8 = std::integral_constant<int, 8>;
  using I16 = std::integral_constant<int, 16>;
  if (p.vec) {
    switch (p.per_thread) {
      case 4: return f(I4{}, I4{});
      case 8: return f(I8{}, I4{});
      case 16: return f(I16{}, I4{});
    }
    return none;
  }
  switch (p.per_thread) {
    case 1: return f(I1{}, I1{});
    case 2: return f(I2{}, I1{});
    case 4: return f(I4{}, I1{});
    case 8: return f(I8{}, I1{});
    case 16: return f(I16{}, I1{});
  }
  return none;
}

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

// Mask of the draw bits a composite key keeps: the low ceil(log2 hw) bits
// (at least one) are replaced by the pixel index, so keys are unique.
__device__ __forceinline__ uint32_t key_high_mask(int hw) {
  int lane_bits = hw > 1 ? 32 - __clz(hw - 1) : 0;
  if (lane_bits < 1) lane_bits = 1;
  return 0xFFFFFFFFu << lane_bits;
}

// A thread's pixels: key i of the thread is pixel start + V * (tid + (i / V)
// * threads) + i % V of the image.
template <int V>
__device__ __forceinline__ int pixel_of(int start, int i) {
  return start + V * (static_cast<int>(threadIdx.x) + (i / V) * static_cast<int>(blockDim.x)) +
         i % V;
}

// V floats at p (a float4 when V == 4) into v.
template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// All CTAs of the cluster (this CTA alone when cs == 1) reach this point, with
// their shared-memory writes before it visible to each other.
__device__ __forceinline__ void cluster_barrier(int cs) {
  if (cs > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
}

// Rank q's copy of a shared-memory array of this CTA's cluster.
template <typename T>
__device__ __forceinline__ const T* peer(const T* p, int q, int cs) {
  return cs > 1 ? cg::this_cluster().map_shared_rank(p, q) : p;
}

// Sum M floats over the cluster: over the block (warp trees, then warps in
// order), then the cs CTAs' sums in rank order, so every thread of every CTA
// gets bitwise the same totals. scratch: kMaxWarps * M + 2 * M floats.
template <int M>
__device__ __forceinline__ void cluster_sum(float (&v)[M], float* scratch, int cs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* part = scratch + kMaxWarps * M;  // this CTA's sums
  float* tot = part + M;                  // the cluster's
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[m] += __shfl_xor_sync(0xffffffffu, v[m], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < M; ++m) scratch[warp * M + m] = v[m];
  }
  __syncthreads();
  if (threadIdx.x < M) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += scratch[w * M + threadIdx.x];
    part[threadIdx.x] = s;
  }
  cluster_barrier(cs);
  if (threadIdx.x < M) {
    float s = 0.f;
    for (int q = 0; q < cs; ++q) s += peer(part, q, cs)[threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < M; ++m) v[m] = tot[m];
}

// Shared memory of N selections run together.
template <int N>
struct SelectSmem {
  int hist[2][N][kBins];      // this CTA's histograms, by round parity
  int tot[N][kBins];          // the cluster's sums of the current round
  int ncand[N];               // this CTA's candidates for the gather finish
  uint32_t cand[N][kGather];
  uint32_t answer[N];
};

// tot <- the CS CTAs' hist[par] summed in rank order, all CS loads of an
// entry in flight together; hist[par ^ 1] <- 0, next round's buffer (every
// peer read it in the previous round, before this round's barrier).
template <int CS, int N>
__device__ __forceinline__ void sum_histograms(SelectSmem<N>& s, int par) {
  const int* mine = &s.hist[par][0][0];
#pragma unroll 2
  for (int e = threadIdx.x; e < N * kBins; e += blockDim.x) {
    int v[CS];
#pragma unroll
    for (int q = 0; q < CS; ++q) v[q] = *peer(mine + e, q, CS);
    int sum = 0;
#pragma unroll
    for (int q = 0; q < CS; ++q) sum += v[q];
    (&s.tot[0][0])[e] = sum;
    (&s.hist[par ^ 1][0][0])[e] = 0;
  }
}

// The digit d of one selection's round with below(d) <= krem < below(d) +
// tot[d], and below(d), found by the calling warp (every lane gets both).
__device__ __forceinline__ void find_digit(const int* tot, int krem, uint32_t& digit,
                                           int& below) {
  constexpr int kPer = kBins / 32;
  const int lane = threadIdx.x & 31;
  int h[kPer], sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; j += 4) {
    const int4 q = *reinterpret_cast<const int4*>(tot + lane * kPer + j);
    h[j] = q.x;
    h[j + 1] = q.y;
    h[j + 2] = q.z;
    h[j + 3] = q.w;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) sum += h[j];
  int inc = sum;  // inclusive scan over the lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  int lo = inc - sum, d = 0, at = 0;
  bool found = false;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (!found && lo <= krem && krem < lo + h[j]) {
      found = true;
      d = lane * kPer + j;
      at = lo;
    }
    lo += h[j];
  }
  const int src = __ffs(__ballot_sync(0xffffffffu, found)) - 1;
  digit = static_cast<uint32_t>(__shfl_sync(0xffffffffu, d, src));
  below = __shfl_sync(0xffffffffu, at, src);
}

// The gather finish: each CTA lists its keys that match prefix[n] in the
// digits at and above `shift` (the selected bin, at most kGather = 64 over the
// cluster); after a cluster barrier warp n pulls selection n's lists through
// distributed shared memory, two keys a lane in rank order, and each lane
// counts, by shuffles, the candidates below and equal to its own: the key
// with krem[n] of them below it (ties counted) is the answer. One cluster
// barrier and one block barrier in place of the remaining rounds.
template <int CS, int N, int P>
__device__ __forceinline__ void gather_finish(const uint32_t (&keys)[N][P], uint32_t valid,
                                              const bool (&active)[N], int shift,
                                              uint32_t (&prefix)[N], const int (&krem)[N],
                                              SelectSmem<N>& s) {
  constexpr unsigned kAll = 0xffffffffu;
  const uint32_t upper = 0xFFFFFFFFu << shift;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (!active[n]) continue;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (((valid >> i) & 1u) && ((keys[n][i] ^ prefix[n]) & upper) == 0) {
        s.cand[n][atomicAdd(&s.ncand[n], 1)] = keys[n][i];
      }
    }
  }
  cluster_barrier(CS);  // every CTA's list is complete
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (!active[n] || warp != n % (blockDim.x >> 5)) continue;
    int c[CS];
#pragma unroll
    for (int q = 0; q < CS; ++q) c[q] = *peer(&s.ncand[n], q, CS);
    uint32_t lo = 0xFFFFFFFFu, hi = 0xFFFFFFFFu;  // candidates lane and lane + 32
    int off = 0;
#pragma unroll
    for (int q = 0; q < CS; ++q) {
      const uint32_t* src = peer(&s.cand[n][0], q, CS);
      if (lane >= off && lane < off + c[q]) lo = src[lane - off];
      if (lane + 32 >= off && lane + 32 < off + c[q]) hi = src[lane + 32 - off];
      off += c[q];
    }
    int lo_less = 0, lo_same = 0, hi_less = 0, hi_same = 0;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const uint32_t a = __shfl_sync(kAll, lo, j), b = __shfl_sync(kAll, hi, j);
      const bool has_a = j < off, has_b = j + 32 < off;
      lo_less += (has_a && a < lo) + (has_b && b < lo);
      lo_same += (has_a && a == lo) + (has_b && b == lo);
      hi_less += (has_a && a < hi) + (has_b && b < hi);
      hi_same += (has_a && a == hi) + (has_b && b == hi);
    }
    if (lane < off && lo_less <= krem[n] && krem[n] < lo_less + lo_same) s.answer[n] = lo;
    if (lane + 32 < off && hi_less <= krem[n] && krem[n] < hi_less + hi_same) s.answer[n] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (active[n]) prefix[n] = s.answer[n];
  }
}

// N exact-k selections over the cluster's keys, in the same rounds: for each
// n with 0 <= k[n] < hw, thr[n] becomes the k[n]-th smallest of the image's
// keys (bit i of valid: key i of this thread is a pixel of the image), so
// exactly k[n] keys are below it. thr[n] = 0 for k[n] < 0 and 0xFFFFFFFF
// for k[n] >= hw, without a select. Every thread of the cluster calls it
// with the same k and hw. Each round: the histograms, a cluster barrier,
// the sums, a block barrier, and every warp's own scan of the sums; once
// every selection's bin holds at most kGather keys, the gather finish.
template <int CS, int N, int P>
__device__ __forceinline__ void radix_select_cs(const uint32_t (&keys)[N][P], uint32_t valid,
                                                const int (&k)[N], const bool (&active)[N],
                                                uint32_t (&thr)[N], SelectSmem<N>& s) {
  uint32_t prefix[N];
  int krem[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    prefix[n] = 0;
    krem[n] = k[n];
  }
  for (int e = threadIdx.x; e < 2 * N * kBins; e += blockDim.x) (&s.hist[0][0][0])[e] = 0;
  if (threadIdx.x < N) s.ncand[threadIdx.x] = 0;
  __syncthreads();
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    const int par = r & 1;
    const int shift = 32 - kDigitBits * (r + 1);
    // the digits above this one: none in round 0
    const uint32_t above = r == 0 ? 0u : 0xFFFFFFFFu << (shift + kDigitBits);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (!active[n]) continue;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        if (((valid >> i) & 1u) && ((keys[n][i] ^ prefix[n]) & above) == 0) {
          atomicAdd(&s.hist[par][n][(keys[n][i] >> shift) & (kBins - 1)], 1);
        }
      }
    }
    cluster_barrier(CS);  // every CTA's histograms of this round are complete
    sum_histograms<CS, N>(s, par);
    __syncthreads();
    bool few = r + 1 < kRounds;  // every selection's bin small enough to gather
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (!active[n]) continue;
      uint32_t d;
      int below;
      find_digit(s.tot[n], krem[n], d, below);
      prefix[n] |= d << shift;
      krem[n] -= below;
      few &= s.tot[n][d] <= kGather;
    }
    if (few) {
      gather_finish<CS>(keys, valid, active, shift, prefix, krem, s);
      break;
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (active[n]) thr[n] = prefix[n];
  }
}

template <int N, int P>
__device__ __forceinline__ void radix_select(const uint32_t (&keys)[N][P], uint32_t valid,
                                             const int (&k)[N], int hw, uint32_t (&thr)[N],
                                             SelectSmem<N>& s, int cs) {
  bool active[N], any = false;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    active[n] = k[n] >= 0 && k[n] < hw;
    any |= active[n];
    thr[n] = k[n] >= hw ? 0xFFFFFFFFu : 0u;
  }
  if (!any) return;
  switch (cs) {
    case 1: return radix_select_cs<1>(keys, valid, k, active, thr, s);
    case 2: return radix_select_cs<2>(keys, valid, k, active, thr, s);
    case 4: return radix_select_cs<4>(keys, valid, k, active, thr, s);
    case 8: return radix_select_cs<8>(keys, valid, k, active, thr, s);
    default: return radix_select_cs<16>(keys, valid, k, active, thr, s);
  }
}

}  // namespace mdt
