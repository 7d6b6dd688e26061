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
// score. With 8-wide heads the exponentials bound the bf16 kernel: 16 ex2 a
// clock per SM on the special-function units against ~2000 bf16 tensor-core
// operations. In fp32 the products, three tf32 products each (split TF32,
// tinyhead_mma.cuh), take 240 operations a score at the TF32 rate: 1.1
// times the exponentials' time, where fp32 on the CUDA cores would take 2.5.
// So both instances rebuild every probability once, in one pass, and keep
// the other work per score few.
//
// One kernel, tinyhead_bwd_kernel, instantiated for bf16 (Bf16) and fp32
// (Tf32): one pass over the scores. A CTA of 4 to 16 warps owns a slice of
// one head's keys (ops/tinyhead_attention.py: tinyhead_bwd_plan: keys a CTA,
// slices a head, warps a CTA); a warp owns kWarpKeys keys (bf16 64, fp32
// 32: tiles of 16), and a slice wider than one pass runs as several. The
// CTA streams all of the head's queries in chunks of 64 (128 from 8
// warps) through a ring of 4 stages in shared memory: q, dO and O rows and
// lse by cp.async; the thread that copied a row's dO and O computes D = dO .
// O once, as soon as its copy lands, and stores -D as the C operand of the
// dP product. Per 16 queries and 16 keys, transposed products:
//   S^T = K q^T, dP^T - D = V dO^T - D   mma.m16n8k8 onto -D
//   P^T, dS^T                            one FFMA + ex2, one FMUL a score
//   dV += P^T dO, dK += dS^T q            the score fragments as A
//   dQ += dS K                            dS^T transposed in registers
//
// bf16 (Bf16): K and V rows in shared memory, q^T and dO^T by ldmatrix; the
// score fragments rounded in pairs to bf16 (cvt.rn) as the A of
// mma.m16n8k16, dO and q by ldmatrix.trans; dS^T transposed by movmatrix;
// K by ldmatrix.trans. P and dS are rounded to bf16 where they enter a
// product, as the forward rounds P and as tinyhead_backward_plain rounds
// them.
//
// fp32 (Tf32): every product in split TF32 (tinyhead_mma.cuh: x = hi + lo,
// lo_a hi_b + hi_a lo_b + hi_a hi_b, fp32 accuracy from the tensor cores;
// torch.backends.cuda.matmul.allow_tf32 does not govern it). The warp's K
// and V fragments ({hi, lo}: K and V as A, K with its keys as B of dQ) sit
// in registers for the pass. The thread that copied a q or dO row splits it
// once, when it lands, into a double buffer of row-major and transposed
// copies (Split), from which ldmatrix gives every fragment: q^T, dO^T as B
// of S^T, dP^T; q, dO (rows 2t, 2t+1) as B of dK, dV, matching the score
// fragments' order as A (c2a). P and dS are split per score (one cvt.rna
// and a subtraction). dQ needs dS with the keys as contraction index, which
// no fragment of dS^T has, and movmatrix moves only 16-bit values: each
// pair of 32-bit values is split into a matrix of their high halves and
// one of their low halves (byte_perm), both transposed, and rejoined: 6
// instructions a pair, where identity products on the tensor cores (8 a
// block) took 6% more of the time on an H100. dK and dV sum in fresh
// accumulators a chunk, added to the pass's on the CUDA cores: the tensor
// cores' sums stay a chunk long (tinyhead_mma.cuh). Per 16 x 16 block: 30
// split m16n8k8 products.
//
// Deterministic, with no atomics and no arrival counter. dK and dV sum in
// each warp's registers over the chunks in order. A warp's dQ part of a
// chunk (fp32) goes to shared memory; after the chunk's barrier the CTA sums
// the parts in warp order. One slice of one pass writes dQ itself, scaled
// and rounded once. Otherwise the CTA writes its fp32 sums to a workspace of
// (slices, B*heads, S, 8) (a later pass adds to what the same thread wrote
// in the pass before), and a second launch, tinyhead_bwd_dq_sum_kernel,
// sums the slices in index order, scales (and rounds to bf16) once. Both are
// plain launches on the caller's stream, so the pair is safe under CUDA
// graph capture.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "tinyhead_mma.cuh"

namespace {

using tinyhead::cp_async;
using tinyhead::cp_async_commit;
using tinyhead::cp_async_wait;
using tinyhead::kD;
using tinyhead::kLog2e;

constexpr int kMinWarps = 4;  // a thread a query row of a chunk, at least (fp32: two)
constexpr int kStages = 4;    // chunks in the cp.async ring

// a chunk's query rows as they land: 8 values of q, dO and O each (kVecs
// 16-byte units), lse and -D
template <int kVecs, int kC>
struct tinyhead_bwd_stage {
  uint4 q[kC][kVecs];
  uint4 dout[kC][kVecs];
  uint4 o[kC][kVecs];
  float lse[kC];      // +inf past S (P = 0)
  float4 nd[kC / 2];  // -{D_2i, D_2i+1, D_2i, D_2i+1}: the dP^T product's C operand
};

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

__device__ __forceinline__ void out_value(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void out_value(float* p, float x) { *p = x; }

// ---- bf16: bf16 products, fp32 sums ---------------------------------------

struct Bf16 {
  using T = __nv_bfloat16;
  static constexpr int kMT = 4;  // 16-key tiles a warp
  static constexpr int kWarpKeys = 16 * kMT;
  static constexpr int kMaxWarps = 16;
  static constexpr int kVecs = 1;  // 16-byte units a row
  static constexpr int kRegs = 128;  // registers a thread: one CTA of 16 warps an SM, or two of 8
  // queries a chunk (one barrier each): 128 for CTAs of 8 warps or more, else 64
  static constexpr int kWideChunk = 128;
  static constexpr int chunk_queries(int warps) { return warps >= 8 ? kWideChunk : 64; }
  template <int kC>
  using Stage = tinyhead_bwd_stage<kVecs, kC>;
  // shared memory besides the ring and the dQ parts: the pass's K and V rows
  template <int kC>
  __host__ __device__ static constexpr size_t extra_bytes(int warps) {
    return 2 * static_cast<size_t>(warps) * kWarpKeys * sizeof(uint4);
  }
  struct Kv {
    const uint4* k;  // the CTA's K rows of the pass
    const uint4* v;  // and V rows
  };

  static __device__ __forceinline__ void load16(uint4 (&dst)[kVecs], const T* base, int row, int s,
                                                int d) {
    dst[0] = tinyhead::load_row(base, row, s, d);
  }
  static __device__ __forceinline__ float dot(const uint4 (&a)[kVecs], const uint4 (&b)[kVecs]) {
    return tinyhead::dot_row(a[0], b[0]);
  }
  // the pass's K and V rows to shared memory, every thread a share; read
  // after the next barrier
  static __device__ __forceinline__ void load_kv(Kv& kv, unsigned char* extra, const T* k,
                                                 const T* v, int key0, int s, int d, int warps,
                                                 int tid) {
    uint4* kvk = reinterpret_cast<uint4*>(extra);
    uint4* kvv = kvk + warps * kWarpKeys;
    for (int r = tid; r < warps * kWarpKeys; r += blockDim.x) {
      kvk[r] = tinyhead::load_row(k, key0 + r, s, d);
      kvv[r] = tinyhead::load_row(v, key0 + r, s, d);
    }
    kv.k = kvk;
    kv.v = kvv;
  }
  template <int kC>
  static __device__ __forceinline__ void finish_rows(const Stage<kC>&, unsigned char*, int, int) {}

  // one chunk of kC queries against the warp's keys; the warp's dQ part of
  // the chunk to `mine`
  template <int kC, bool kMasked>
  static __device__ __forceinline__ void chunk(const Stage<kC>& st, const unsigned char*, int,
                                               const Kv& kv, float (&dka)[kMT][4],
                                               float (&dva)[kMT][4], float* mine, int warp,
                                               int lane, int wkey0, int s, float c) {
    using namespace tinyhead;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < kC / 16; ++h) {
      // lanes 0-15 address q rows, 16-31 dO rows of these 16 queries:
      // f = q^T, q^T, dO^T, dO^T B fragments of the two 8-query tiles;
      // ft = q and dO as B fragments over the 16 queries
      uint32_t f[4], ft[4];
      const uint4* rows = (lane < 16 ? st.q[0] : st.dout[0]) + h * 16 + (lane & 15);
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
        ldsm_x4(kva, (lane < 16 ? kv.k : kv.v) + tile);
        ldsm_x2_t(kb, kv.k + tile);
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
            if constexpr (kMasked) {
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
  }
};

// ---- fp32: split-TF32 products, fp32 sums ---------------------------------

struct Tf32 {
  using T = float;
  static constexpr int kMT = 2;  // 16-key tiles a warp
  static constexpr int kWarpKeys = 16 * kMT;
  static constexpr int kMaxWarps = 8;
  static constexpr int kVecs = 2;
  // registers a thread: ptxas takes 226 and spills none (168 spilled 96
  // bytes and ran 11% slower on an H100); one CTA of 8 warps an SM either
  // way
  static constexpr int kRegs = 255;
  static constexpr int kWideChunk = 128;  // queries a chunk from 8 warps (64 below)
  static constexpr int chunk_queries(int warps) { return warps >= 8 ? kWideChunk : 64; }
  template <int kC>
  using Stage = tinyhead_bwd_stage<kVecs, kC>;

  // a chunk's q and dO split into tf32 {hi, lo}: by rows (swizzled 8-float
  // rows: tinyhead::swz) and transposed ([dim][pair_pos(query)], kTS floats
  // a dim: 16-byte units an odd number apart, so ldmatrix rows miss each
  // other's banks)
  template <int kC>
  struct Split {
    static constexpr int kTS = kC + 4;
    float qr[2][kC * kD];
    float dr[2][kC * kD];
    float qt[2][kD * kTS];
    float dt[2][kD * kTS];
  };
  // two Splits: finish fills chunk j + 1's while the warps read chunk j's
  template <int kC>
  __host__ __device__ static constexpr size_t extra_bytes(int) {
    return 2 * sizeof(Split<kC>);
  }
  // the warp's keys, {hi, lo}: K and V as A fragments of S^T and dP^T, and
  // K as the B fragments {hi b0, hi b1, lo b0, lo b1} of dQ += dS K, keys
  // 8kb + 2t and 8kb + 2t + 1 of each 16
  struct Kv {
    uint32_t k[kMT][2][4];
    uint32_t v[kMT][2][4];
    uint32_t kt[kMT][2][4];
  };

  static __device__ __forceinline__ void load16(uint4 (&dst)[kVecs], const T* base, int row, int s,
                                                int d) {
    float x[kD];
    tinyhead::load_row(base, row, s, d, x);
    dst[0] = make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                        __float_as_uint(x[3]));
    dst[1] = make_uint4(__float_as_uint(x[4]), __float_as_uint(x[5]), __float_as_uint(x[6]),
                        __float_as_uint(x[7]));
  }
  static __device__ __forceinline__ float dot(const uint4 (&a)[kVecs], const uint4 (&b)[kVecs]) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      acc = fmaf(__uint_as_float(a[i].x), __uint_as_float(b[i].x), acc);
      acc = fmaf(__uint_as_float(a[i].y), __uint_as_float(b[i].y), acc);
      acc = fmaf(__uint_as_float(a[i].z), __uint_as_float(b[i].z), acc);
      acc = fmaf(__uint_as_float(a[i].w), __uint_as_float(b[i].w), acc);
    }
    return acc;
  }
  // the warp's fragments of the pass's keys, from device memory, split
  static __device__ __forceinline__ void load_kv(Kv& kv, unsigned char*, const T* k, const T* v,
                                                 int key0, int s, int d, int, int tid) {
    using namespace tinyhead;
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int wkey0 = key0 + (tid >> 5) * kWarpKeys;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int r0 = wkey0 + mt * 16;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + g + 8 * (i & 1), col = t + 4 * (i >> 1);
        split_tf32(load_at(k, row, col, s, d), kv.k[mt][0][i], kv.k[mt][1][i]);
        split_tf32(load_at(v, row, col, s, d), kv.v[mt][0][i], kv.v[mt][1][i]);
      }
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          split_tf32(load_at(k, r0 + 8 * kb + 2 * t + b, g, s, d), kv.kt[mt][kb][b],
                     kv.kt[mt][kb][2 + b]);
        }
      }
    }
  }
  // after its copies landed: thread r < kC splits dO row r, thread kC + r
  // q row r, into chunk j's Split
  template <int kC>
  static __device__ __forceinline__ void finish_rows(const Stage<kC>& st, unsigned char* extra,
                                                     int j, int tid) {
    if (tid >= 2 * kC) return;
    Split<kC>& sp = reinterpret_cast<Split<kC>*>(extra)[j & 1];
    const bool dout = tid < kC;
    const int r = tid & (kC - 1);
    const uint4* src = dout ? st.dout[r] : st.q[r];
    const float x[kD] = {__uint_as_float(src[0].x), __uint_as_float(src[0].y),
                         __uint_as_float(src[0].z), __uint_as_float(src[0].w),
                         __uint_as_float(src[1].x), __uint_as_float(src[1].y),
                         __uint_as_float(src[1].z), __uint_as_float(src[1].w)};
    tinyhead::store_split(x, r, dout ? sp.dr[0] : sp.qr[0], dout ? sp.dr[1] : sp.qr[1],
                          dout ? sp.dt[0] : sp.qt[0], dout ? sp.dt[1] : sp.qt[1],
                          Split<kC>::kTS);
  }

  template <int kC, bool kMasked>
  static __device__ __forceinline__ void chunk(const Stage<kC>& st, const unsigned char* extra,
                                               int j, const Kv& kv, float (&dka)[kMT][4],
                                               float (&dva)[kMT][4], float* mine, int,
                                               int lane, int wkey0, int s, float c) {
    using namespace tinyhead;
    using S = Split<kC>;
    const S& sp = reinterpret_cast<const S*>(extra)[j & 1];
    const int g = lane >> 2, t = lane & 3;
    // the chunk's sums of dK and dV (short tensor-core sums)
    float dkc[kMT][4], dvc[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) dkc[mt][i] = dvc[mt][i] = 0.f;
    }
#pragma unroll 1
    for (int h = 0; h < kC / 16; ++h) {
      // B fragments of the two 8-query tiles: q^T, dO^T of S^T and dP^T;
      // q, dO (queries 2t, 2t+1) of dK and dV
      uint32_t fq[2][4], fd[2][4], gq[2][4], gd[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int q0 = h * 16 + nt * 8;
        ldsm_x4(fq[nt], frag_rows(sp.qr[0], sp.qr[1], q0, lane));
        ldsm_x4(fd[nt], frag_rows(sp.dr[0], sp.dr[1], q0, lane));
        ldsm_x4(gq[nt], frag_cols(sp.qt[0], sp.qt[1], q0, S::kTS, lane));
        ldsm_x4(gd[nt], frag_cols(sp.dt[0], sp.dt[1], q0, S::kTS, lane));
      }
      float2 ls[2];
      float4 nd[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        ls[nt] = *reinterpret_cast<const float2*>(&st.lse[h * 16 + nt * 8 + 2 * t]);
        nd[nt] = st.nd[h * 8 + nt * 4 + t];
      }
      float dqa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t ds[2][2][4];  // dS^T of each 8-query tile, {hi, lo} in A order
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float sc[4] = {0.f, 0.f, 0.f, 0.f};
          float dp[4] = {nd[nt].x, nd[nt].y, nd[nt].z, nd[nt].w};
          mma_tf32x3(sc, kv.k[mt], fq[nt]);
          mma_tf32x3(dp, kv.v[mt], fd[nt]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float p = ex2(fmaf(sc[i], c, (i & 1) ? -ls[nt].y : -ls[nt].x));
            if constexpr (kMasked) {
              if (wkey0 + mt * 16 + g + 8 * (i >> 1) >= s) p = 0.f;  // keys past S
            }
            sc[i] = p;
            dp[i] *= p;
          }
          uint32_t pa[2][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            split_tf32(sc[c2a(i)], pa[0][i], pa[1][i]);
            split_tf32(dp[c2a(i)], ds[nt][0][i], ds[nt][1][i]);
          }
          mma_tf32x3(dvc[mt], pa, gd[nt]);
          mma_tf32x3(dkc[mt], ds[nt], gq[nt]);
        }
        // dS (16 queries x 8 keys, the kb-th 8 of the tile) as dQ's A
        // fragments: each 8 x 8 block of dS^T's hi (then lo) values, keys g
        // by queries 2t, 2t+1, transposed as two b16 matrices of their high
        // and low halves (movmatrix), rejoined: (query g, keys 2t, 2t+1)
#pragma unroll
        for (int kb = 0; kb < 2; ++kb) {
          uint32_t da[2][4];
#pragma unroll
          for (int part = 0; part < 2; ++part) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const uint32_t x0 = ds[nt][part][kb], x1 = ds[nt][part][kb + 2];
              const uint32_t hi = movtrans(__byte_perm(x0, x1, 0x7632));
              const uint32_t lo = movtrans(__byte_perm(x0, x1, 0x5410));
              da[part][nt] = __byte_perm(lo, hi, 0x5410);      // key 2t
              da[part][nt + 2] = __byte_perm(lo, hi, 0x7632);  // key 2t + 1
            }
          }
          mma_tf32x3(dqa, da, kv.kt[mt][kb]);
        }
      }
      // this warp's dQ part of queries h*16 + g and h*16 + g + 8
      const int qrow = h * 16 + g;
      *reinterpret_cast<float2*>(&mine[qrow * kD + 2 * t]) = make_float2(dqa[0], dqa[1]);
      *reinterpret_cast<float2*>(&mine[(qrow + 8) * kD + 2 * t]) = make_float2(dqa[2], dqa[3]);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dka[mt][i] += dkc[mt][i];
        dva[mt][i] += dvc[mt][i];
      }
    }
  }
};

template <class Tr, int kC>
constexpr size_t smem_bytes(int warps) {
  return kStages * sizeof(typename Tr::template Stage<kC>) + Tr::template extra_bytes<kC>(warps) +
         2 * static_cast<size_t>(warps) * kC * kD * sizeof(float);
}

// kC: queries a chunk. kFull: d == 8, query rows copied by cp.async; else
// rows of d < 8 values zero-padded to 8 by plain loads
template <class Tr, int kC, bool kFull>
__global__ void __maxnreg__(Tr::kRegs) tinyhead_bwd_kernel(const typename Tr::T* __restrict__ q,
                                    const typename Tr::T* __restrict__ k,
                                    const typename Tr::T* __restrict__ v,
                                    const typename Tr::T* __restrict__ o,
                                    const float* __restrict__ lse,
                                    const typename Tr::T* __restrict__ dout,
                                    typename Tr::T* __restrict__ dq, float* __restrict__ ws,
                                    typename Tr::T* __restrict__ dk,
                                    typename Tr::T* __restrict__ dv, int bh, int s, int d,
                                    int keys_cta, int slices, float c, float scale) {
  using namespace tinyhead;
  constexpr int kMT = Tr::kMT, kWarpKeys = Tr::kWarpKeys;
  constexpr int kPart = kC * kD;  // fp32 dQ values of a chunk
  using Stage = typename Tr::template Stage<kC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  Stage* ring = reinterpret_cast<Stage*>(smem);
  unsigned char* extra = reinterpret_cast<unsigned char*>(ring + kStages);
  // [2][warps][kPart]
  float* part = reinterpret_cast<float*>(extra + Tr::template extra_bytes<kC>(warps));

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
#pragma unroll
          for (int u = 0; u < Tr::kVecs; ++u) {
            cp_async<16>(&st.dout[r][u], reinterpret_cast<const uint4*>(dout + off) + u, in);
            cp_async<16>(&st.o[r][u], reinterpret_cast<const uint4*>(o + off) + u, in);
          }
          cp_async<4>(&st.lse[r], lse + lat + (in ? row : 0), in);
        } else {
          Tr::load16(st.dout[r], dout + at, row, s, d);
          Tr::load16(st.o[r], o + at, row, s, d);
          st.lse[r] = in ? lse[lat + row] : 0.f;
        }
      } else if constexpr (kFull) {
#pragma unroll
        for (int u = 0; u < Tr::kVecs; ++u) {
          cp_async<16>(&st.q[r][u], reinterpret_cast<const uint4*>(q + off) + u, in);
        }
      } else {
        Tr::load16(st.q[r], q + at, row, s, d);
      }
    }
  };
  // D of a row of chunk j, by the thread that copied its dO and O, once its
  // copies have landed; rows past S get lse = +inf (P = 0) and D = 0
  auto finish = [&](int j, int slot) {
    Stage& st = ring[slot];
    if (tid < kC) {
      const int r = tid;
      const bool in = j * kC + r < s;
      const float nd = in ? -Tr::dot(st.dout[r], st.o[r]) : 0.f;
      float* pair = &st.nd[r >> 1].x;
      pair[r & 1] = pair[(r & 1) + 2] = nd;
      if (!in) st.lse[r] = INFINITY;
    }
    Tr::template finish_rows<kC>(st, extra, j, tid);
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
            out_value(&dq[at + static_cast<size_t>(row) * d + col + i], acc.x[i] * scale);
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
    typename Tr::Kv kv;
    Tr::load_kv(kv, extra, k + at, v + at, key0, s, d, warps, tid);

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
        Tr::template chunk<kC, true>(ring[j % kStages], extra, j, kv, dka, dva, mine, warp, lane,
                                     wkey0, s, c);
      } else {
        Tr::template chunk<kC, false>(ring[j % kStages], extra, j, kv, dka, dva, mine, warp, lane,
                                      wkey0, s, c);
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

// dq = scale * sum over slices of ws (rounded to bf16 for bf16), the slices
// in index order; one thread a row of (B*heads*S, d)
template <class T>
__global__ void __launch_bounds__(256) tinyhead_bwd_dq_sum_kernel(const float* __restrict__ ws,
                                                                  T* __restrict__ dq, int rows,
                                                                  int slices, int d,
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
  T* out = dq + static_cast<size_t>(row) * d;
  if constexpr (std::is_same_v<T, float>) {
    if (d == kD) {
      reinterpret_cast<float4*>(out)[0] = make_float4(r[0] * scale, r[1] * scale, r[2] * scale,
                                                      r[3] * scale);
      reinterpret_cast<float4*>(out)[1] = make_float4(r[4] * scale, r[5] * scale, r[6] * scale,
                                                      r[7] * scale);
    } else {
      for (int i = 0; i < d; ++i) out[i] = r[i] * scale;
    }
  } else if (d == kD) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = tinyhead::pack_bf16(r[2 * i] * scale, r[2 * i + 1] * scale);
    *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int i = 0; i < d; ++i) out[i] = __float2bfloat16_rn(r[i] * scale);
  }
}

// the plan as the kernel takes it (ops/tinyhead_attention.py:tinyhead_bwd_plan):
// 4 to kMaxWarps warps, a whole number of passes, every key in one slice and
// no slice empty, and a workspace exactly when dQ has parts to sum
template <class Tr>
bool bwd_plan_ok(int s, int keys_cta, int slices, int warps, bool has_ws) {
  if (warps < kMinWarps || warps > Tr::kMaxWarps || slices < 1 || keys_cta <= 0 ||
      keys_cta % (Tr::kWarpKeys * warps) != 0) {
    return false;
  }
  if (static_cast<long long>(slices) * keys_cta < s ||
      static_cast<long long>(slices - 1) * keys_cta >= s) {
    return false;
  }
  const bool parts = slices > 1 || keys_cta > Tr::kWarpKeys * warps;
  return parts == has_ws;
}

template <class Tr, int kC, bool kFull>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* out,
                       const float* lse, const void* dout, void* dq, float* ws, void* dk, void* dv,
                       int bh, int s, int d, int keys_cta, int slices, int warps, float c,
                       float scale, cudaStream_t st) {
  using T = typename Tr::T;
  auto kernel = tinyhead_bwd_kernel<Tr, kC, kFull>;
  const size_t smem = smem_bytes<Tr, kC>(warps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<bh * slices, warps * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), lse, static_cast<const T*>(dout), static_cast<T*>(dq), ws,
      static_cast<T*>(dk), static_cast<T*>(dv), bh, s, d, keys_cta, slices, c, scale);
  return cudaGetLastError();
}

// the plan checked, the kernel, then the slice sum when there is a workspace
template <class Tr>
cudaError_t backward(const void* q, const void* k, const void* v, const void* out,
                     const float* lse, const void* dout, void* dq, float* ws, void* dk, void* dv,
                     int bh, int s, int d, int keys_cta, int slices, int warps, float c,
                     float scale, cudaStream_t st) {
  if (!bwd_plan_ok<Tr>(s, keys_cta, slices, warps, ws != nullptr) ||
      static_cast<long long>(bh) * slices > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  constexpr int kWide = Tr::kWideChunk;
  auto launch = Tr::chunk_queries(warps) == kWide
                    ? (d == kD ? launch_bwd<Tr, kWide, true> : launch_bwd<Tr, kWide, false>)
                    : (d == kD ? launch_bwd<Tr, 64, true> : launch_bwd<Tr, 64, false>);
  cudaError_t err = launch(q, k, v, out, lse, dout, dq, ws, dk, dv, bh, s, d, keys_cta, slices,
                           warps, c, scale, st);
  if (err != cudaSuccess || ws == nullptr) return err;
  const int rows = bh * s;
  tinyhead_bwd_dq_sum_kernel<typename Tr::T><<<(rows + 255) / 256, 256, 0, st>>>(
      ws, static_cast<typename Tr::T*>(dq), rows, slices, d, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out, dout, dq, dk, dv: bh rows of (s, d) values, dtype 0 = fp32,
// 1 = bf16; lse: (bh, s) fp32 from the forward. The one-pass kernel on the
// plan (keys_cta, slices, warps), then, when ws is given ((slices, bh, s, 8)
// fp32, for a plan with more than one slice or pass), the slice sum; a plan
// the kernel does not take returns cudaErrorInvalidValue.
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
  auto* w = static_cast<float*>(ws);
  const cudaError_t err =
      dtype == 0 ? backward<Tf32>(q, k, v, out, l, dout, dq, w, dk, dv, bh, s, d, keys_cta, slices,
                                  warps, c, scale, st)
                 : backward<Bf16>(q, k, v, out, l, dout, dq, w, dk, dv, bh, s, d, keys_cta, slices,
                                  warps, c, scale, st);
  return static_cast<int>(err);
}
