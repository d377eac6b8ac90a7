// GQA prefill attention (causal or not) with an online softmax, for Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (behind
// ops.flash_attention); semantics pinned by
// src/repro/kernels/ref.py::flash_attention_ref: for query head h and KV
// head h / G, softmax over the keys (kpos <= qpos when causal; masked
// scores -1e30) of (q . k) * scale in f32, times v; the denominator is
// clamped at 1e-30.  The Pallas kernel skips a KV block when
// qi * block_q < ki * block_k, which also drops blocks that hold valid keys
// when block_q > block_k; these kernels compute the reference function and
// skip a KV tile only when its first key lies past the last query of the
// tile.  Any S: keys past S are excluded and rows past S are not written.
// With the causal mask the tiles with the most work are launched first.
//
// What bounds it: operations.  Causal prefill at minitron-4b's shape
// (2 x 4096, 24/8 heads, hd 128) does 4 * B * H * hd * S^2 / 2 = 2.1e11
// operations on 0.1 GB of q, k, v and output: about 2000 operations per
// byte, far above the card's 295, so only the tensor cores can approach
// the bound.
//
// bf16 (flash_kernel_wgmma): a block of two consumer warpgroups and one
// producer warpgroup owns 128 queries of one (sequence, query head); each
// consumer warpgroup owns 64 of them.  The producer hands most of its
// registers to the consumers (setmaxnreg: 24 against 240 a thread, so S,
// O and P fit without spills), and one of its threads loads the Q tile
// once and the 128-key K and V tiles into two-stage rings in shared memory
// with TMA (cp.async.bulk.tensor through 4-D tensor maps over (hd, heads,
// S, B), completing on mbarriers; the consumers free each K and each V
// stage through other mbarriers).  TMA writes the 128-byte swizzle
// (64-byte at hd 32) that the wgmma descriptors read, and fills rows past
// S with zeros.  Per tile a warpgroup computes S = Q K^T with
// wgmma.m64n128k16 (Q and K from shared memory, f32 accumulators), runs
// the online softmax on the accumulator fragment (a thread holds two rows;
// row max and sum over the four lanes of a quad; exp2 of
// s * scale * log2(e) - m in one FFMA and one MUFU op; keys past S score
// -inf and masked keys -1e30, in the last tile only, the one tile that can
// cross the diagonal or S), rounds P to bf16 in registers (the m64n128
// accumulator layout is the k16 A-operand layout) and accumulates
// O += P V with wgmma.m64n{hd}k16, P from registers and V from shared
// memory through the transpose bit (no V^T copy).
//
// What keeps the tensor cores busy: the softmax (about as many
// instructions per tile as the two products take tensor-core time) runs
// beside the products.  Within a warpgroup, S of tile t is started
// together with P V of tile t - 1, and the softmax of tile t runs while
// that P V is in flight; across the two warpgroups, named barriers hand
// the turn to start products back and forth, so one warpgroup's softmax
// runs while the other's products execute.
//
// Rounding P to bf16 costs up to 2^-9 of |v| in a row that sums few keys
// (the first rows of a causal prefill), where nothing averages it out: for
// the last tile, what the rounding left over is rounded to bf16 too and
// multiplied in a second pass of P V.  Q (32 KB at hd 128) and two stages
// of K and V (128 KB) take 161 KB of shared memory: one block per SM.
//
// hd 16 (the reference's smoke configs), f32 and bf16: flash_kernel, the
// FMA template below, instantiated for both types (bf16 loads widened to
// f32, all arithmetic in f32).  At 32 bytes a row there is too little
// depth per key for a wgmma tile to pay for its set-up.
//
// f32 (flash_kernel): f32 FMAs on the CUDA cores.  TF32 tensor cores keep
// about three decimal digits, short of the f32 tolerance (2e-5), so f32
// stays here.  A block of 256 threads owns kBQ = 64 queries of one
// (sequence, query head), walks the KV tiles of kBK = 64 keys in order and
// keeps the online-softmax state in registers.  Q, K and V tiles are
// staged in shared memory as f32 (rows padded by one float against bank
// conflicts; about 113 KB at hd = 128, so the launch opts in above 48 KB).
// Thread (ty, tx) of a 16 x 16 grid computes the scores of rows ty + 16 i
// and keys tx + 16 j (4 x 4 in registers), reduces the row max and sum
// over the 16 lanes of its half-warp with shuffles, writes the
// probabilities to shared memory, and accumulates rows ty + 16 i, columns
// tx + 16 j of P V.  The GQA mapping is in the address: no K/V is
// replicated.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>

#include "bounds.cuh"
#include "float_io.cuh"
#include "hopper.cuh"

namespace {

using xlb::from_f32;
using xlb::to_f32;

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr float kNegInf = -1e30f;

struct FlashArgs {
  const void *q, *k, *v;
  void* out;
  int S, H, K, G, causal;
  long long qsb, qss, qsh;
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  long long osb, oss, osh;
  float scale;
#ifdef XLB_BOUNDS_CHECK
  long long nq, nk, nv, no;   // extents in elements
#endif
};

template <int HD>
__host__ __device__ constexpr int smem_bytes() {
  return (int)sizeof(float) *
         (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(FlashArgs a) {
  constexpr int kC = HD / 16;              // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                       // (kBQ, HD + 1)
  float* k_s = q_s + kBQ * (HD + 1);       // (kBK, HD + 1)
  float* v_s = k_s + kBK * (HD + 1);       // (kBK, HD)
  float* p_s = v_s + kBK * HD;             // (kBQ, kBK + 1)

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, kh = h / a.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int S = a.S;

  XLB_SMEM(0, smem_bytes<HD>());
  const T* qb = q + b * a.qsb + h * a.qsh;
  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    if (q0 + r < S)
      XLB_CHECK(b * a.qsb + h * a.qsh + (long long)(q0 + r) * a.qss + d, a.nq);
    q_s[r * (HD + 1) + d] =
        q0 + r < S ? to_f32(qb[(long long)(q0 + r) * a.qss + d]) : 0.f;
  }
  float m[4], l[4], acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = a.causal ? q_last + 1 : S;
  const T* kb = k + b * a.ksb + kh * a.ksh;
  const T* vb = v + b * a.vsb + kh * a.vsh;

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();                       // the last tile's readers are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int t = i / HD, d = i % HD;
      const bool in = k0 + t < S;
      const long long s = k0 + t;
      if (in) {
        XLB_CHECK(b * a.ksb + kh * a.ksh + s * a.kss + d, a.nk);
        XLB_CHECK(b * a.vsb + kh * a.vsh + s * a.vss + d, a.nv);
      }
      k_s[t * (HD + 1) + d] = in ? to_f32(kb[s * a.kss + d]) : 0.f;
      v_s[t * HD + d] = in ? to_f32(vb[s * a.vss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * a.scale;
        if (kpos >= S) x = -INFINITY;                 // no such key
        else if (a.causal && kpos > qpos) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        p_s[r * (kBK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float pv[4], vv[kC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * (kBK + 1) + t];
#pragma unroll
      for (int c = 0; c < kC; ++c) vv[c] = v_s[t * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[i][c] += pv[i] * vv[c];
    }
  }

  T* ob = static_cast<T*>(a.out) + b * a.osb + h * a.osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < S) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        XLB_CHECK(b * a.osb + h * a.osh + (long long)r * a.oss + tx + 16 * c,
                  a.no);
        ob[(long long)r * a.oss + tx + 16 * c] = from_f32<T>(acc[i][c] / den);
      }
    }
  }
}

template <typename T, int HD>
int launch_fma(const FlashArgs& a, int B, cudaStream_t st) {
  constexpr int smem = smem_bytes<HD>();
  cudaError_t err = xlb::allow_smem(flash_kernel<T, HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * a.H, (a.S + kBQ - 1) / kBQ);
  flash_kernel<T, HD><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores ----------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;                   // queries per block
constexpr int kBK = 128;                   // keys per K/V tile
constexpr int kStages = 2;                 // K/V ring
constexpr int kConsumers = 256;            // two warpgroups of 64 queries
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Geo {
  static constexpr int SW = HD * 2 < 128 ? HD * 2 : 128;  // bytes per panel row
  static constexpr int PW = SW / 2;        // head dims per panel
  static constexpr int NP = HD / PW;       // panels of a tile
  static constexpr int Q = kBQ * HD * 2;   // bytes of the Q tile
  static constexpr int KV = kBK * HD * 2;  // bytes of one K or V tile
  static constexpr int BARS = Q + kStages * 2 * KV;
  // mbarriers: Q full; K full, V full, K empty, V empty per stage
  static constexpr int SMEM = 1024 + BARS + 8 * (1 + 4 * kStages);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// What rounding (x0, x1) to the bf16 pair `hi` left over, as a bf16 pair.
__device__ __forceinline__ uint32_t pack_bf16_rest(float x0, float x1,
                                                   uint32_t hi) {
  return pack_bf16(x0 - __uint_as_float(hi << 16),
                   x1 - __uint_as_float(hi & 0xffff0000u));
}

// S = Q K^T for one warpgroup: 64 queries (qa) x 128 keys (ks), K-major
// swizzled panels.
template <int HD>
__device__ __forceinline__ void mma_qk(float (&sc)[64], uint32_t qa,
                                         uint32_t ks) {
  constexpr int SW = Geo<HD>::SW, PW = Geo<HD>::PW;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int p = kk / (PW / 16), off = (kk % (PW / 16)) * 32;
    xlb::wgmma_m64n128_ss(
        sc, xlb::wgmma_desc(qa + p * kBQ * SW + off, 16, 8 * SW, SW),
        xlb::wgmma_desc(ks + p * kBK * SW + off, 16, 8 * SW, SW), kk > 0);
  }
}

// O += P V: P (64 x 128 keys) from registers, V (128 keys x hd) read
// through the transpose bit; with kRest also the rest of P's rounding.
// (No wgmma sits under a runtime branch: ptxas would serialise them all.)
template <int HD, bool kRest>
__device__ __forceinline__ void mma_pv(float (&o)[HD / 2],
                                         uint32_t (&pa)[kBK / 16][4],
                                         uint32_t (&pr)[kBK / 16][4],
                                         uint32_t vs) {
  constexpr int SW = Geo<HD>::SW;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    xlb::wgmma_rs_tb(o, pa[kk], xlb::wgmma_desc(vs + kk * 16 * SW, kBK * SW,
                                                8 * SW, SW));
  if constexpr (kRest) {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      xlb::wgmma_rs_tb(o, pr[kk], xlb::wgmma_desc(vs + kk * 16 * SW,
                                                  kBK * SW, 8 * SW, SW));
  }
}

// 2^x in one MUFU instruction (subnormal results flush to 0).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one score tile, in place: sc (q . k) becomes P
// (f32), m the new row maxima of the scores times scale * log2(e), alpha
// the factor the old O and l are scaled by; l gains the tile's row sums
// (this thread's columns).  Accumulator element j is row
// row_lo + 8 ((j >> 1) & 1), key k0 + 8 (j / 4) + col_lane + (j & 1).
// Only the last tile can cross the diagonal or S (kLast): there keys past
// S score -inf and masked keys -1e30.  The mask is a template argument,
// not a runtime test, so the other tiles spend no instruction on it.
template <bool kLast>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int row_lo, int col_lane,
                                             const FlashArgs& a, float sl2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    if constexpr (kLast) {
      const int col = k0 + 8 * (j / 4) + col_lane + (j & 1);
      const int row = row_lo + 8 * ((j >> 1) & 1);
      if (col >= a.S) sc[j] = -INFINITY;              // no such key
      else if (a.causal && col > row) sc[j] = kNegInf;
    }
    mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * sl2);   // scale > 0
    alpha[i] = exp2_ftz(m[i] - m_new);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const float p = exp2_ftz(fmaf(sc[j], sl2, -m[(j >> 1) & 1]));
    sc[j] = p;
    l[(j >> 1) & 1] += p;
  }
}

// P as bf16 A fragments (the m64n128 accumulator layout is the k16 A
// layout: pair 2 r of slice kk is elements 8 kk + 2 r and + 1); for the
// last tile also the rest of the rounding.
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&pa)[kBK / 16][4],
                                       uint32_t (&pr)[kBK / 16][4],
                                       bool last) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
      pa[kk][r] = pack_bf16(x0, x1);
      pr[kk][r] = last ? pack_bf16_rest(x0, x1, pa[kk][r]) : 0u;
    }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, FlashArgs a) {
  using Gm = Geo<HD>;
  constexpr int SW = Gm::SW, PW = Gm::PW, NP = Gm::NP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t q_s = (xlb::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv0 = q_s + Gm::Q;  // stage s: K at kv0 + 2 s KV, then V
  const uint32_t q_full = q_s + Gm::BARS;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;
  auto k_at = [&](int s) { return kv0 + s * 2 * Gm::KV; };
  auto v_at = [&](int s) { return kv0 + s * 2 * Gm::KV + Gm::KV; };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, kh = h / a.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int S = a.S;
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = a.causal ? q_last + 1 : S;
  const int n = (k_end + kBK - 1) / kBK;      // K/V tiles

  // the tiles and barriers end inside the launch's dynamic shared memory
  XLB_SMEM(v_empty + 8 * kStages - xlb::smem_u32(smem_raw) - 1, 1);
  if (tid == 0) {
    xlb::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      xlb::mbar_init(k_full + 8 * s, 1);
      xlb::mbar_init(v_full + 8 * s, 1);
      xlb::mbar_init(k_empty + 8 * s, kConsumers);
      xlb::mbar_init(v_empty + 8 * s, kConsumers);
    }
    xlb::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {                    // the producer
    xlb::regs_dec<24>();                      // its registers go to the
                                              // consumers' accumulators
    if (tid == kConsumers) {
      xlb::mbar_expect_tx(q_full, Gm::Q);
      for (int p = 0; p < NP; ++p)
        xlb::tma_load_4d(q_s + p * kBQ * SW, &tm_q, q_full, p * PW, h, q0, b);
      for (int t = 0; t < n; ++t) {
        const int s = t % kStages, phase = ((t / kStages) & 1) ^ 1;
        xlb::mbar_wait(k_empty + 8 * s, phase);
        xlb::mbar_expect_tx(k_full + 8 * s, Gm::KV);
        for (int p = 0; p < NP; ++p)
          xlb::tma_load_4d(k_at(s) + p * kBK * SW, &tm_k, k_full + 8 * s,
                           p * PW, kh, t * kBK, b);
        xlb::mbar_wait(v_empty + 8 * s, phase);
        xlb::mbar_expect_tx(v_full + 8 * s, Gm::KV);
        for (int p = 0; p < NP; ++p)
          xlb::tma_load_4d(v_at(s) + p * kBK * SW, &tm_v, v_full + 8 * s,
                           p * PW, kh, t * kBK, b);
      }
    }
    return;
  }

  // The consumer warpgroups.  Warpgroup w starts its wgmmas only in its
  // turn (named barrier 1 + w, opened by the other warpgroup once it has
  // started its own), so one warpgroup's softmax runs while the other's
  // products keep the tensor cores busy; warpgroup 0 goes first.  Within
  // a warpgroup, S of tile t is started together with P V of tile t - 1,
  // and the softmax of tile t runs while that P V is in flight.
  xlb::regs_inc<240>();
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int my_turn = 1 + wg, other_turn = 2 - wg;
  const int row_lo = q0 + wg * 64 + warp * 16 + lane / 4;  // and row_lo + 8
  const int col_lane = 2 * (lane % 4);
  const float sl2 = a.scale * kLog2e;
  const uint32_t qa = q_s + wg * 64 * SW;
  float o[HD / 2], sc[64], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float alpha[2];
  uint32_t pa[kBK / 16][4], pr[kBK / 16][4];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;
  if (wg == 1) xlb::bar_arrive(1, kConsumers);

  // tile 0: S only
  xlb::mbar_wait(q_full, 0);
  xlb::mbar_wait(k_full, 0);
  xlb::bar_sync(my_turn, kConsumers);
  xlb::wgmma_fence();
  mma_qk<HD>(sc, qa, k_at(0));
  xlb::wgmma_commit();
  xlb::bar_arrive(other_turn, kConsumers);
  xlb::wgmma_wait<0>();
  xlb::reg_fence(sc);
  xlb::mbar_arrive(k_empty);
  if (n == 1) softmax_tile<true>(sc, m, l, alpha, 0, row_lo, col_lane, a, sl2);
  else softmax_tile<false>(sc, m, l, alpha, 0, row_lo, col_lane, a, sl2);
  pack_p(sc, pa, pr, n == 1);

  for (int t = 1; t < n; ++t) {
    const int s = t % kStages, sp = (t - 1) % kStages;
    xlb::mbar_wait(k_full + 8 * s, (t / kStages) & 1);
    xlb::bar_sync(my_turn, kConsumers);
    xlb::reg_fence(o);
    xlb::wgmma_fence();
    mma_qk<HD>(sc, qa, k_at(s));
    xlb::wgmma_commit();
    xlb::mbar_wait(v_full + 8 * sp, ((t - 1) / kStages) & 1);
    mma_pv<HD, false>(o, pa, pr, v_at(sp));
    xlb::wgmma_commit();
    xlb::bar_arrive(other_turn, kConsumers);
    xlb::wgmma_wait<1>();                       // S of tile t
    xlb::reg_fence(sc);
    xlb::mbar_arrive(k_empty + 8 * s);
    if (t == n - 1)
      softmax_tile<true>(sc, m, l, alpha, t * kBK, row_lo, col_lane, a, sl2);
    else
      softmax_tile<false>(sc, m, l, alpha, t * kBK, row_lo, col_lane, a, sl2);
    xlb::wgmma_wait<0>();                       // P V of tile t - 1
    xlb::reg_fence(o);
    xlb::reg_fence(pa);
    xlb::reg_fence(pr);
    xlb::mbar_arrive(v_empty + 8 * sp);
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
    pack_p(sc, pa, pr, t == n - 1);
  }

  // tile n - 1: P V with the rest of P's rounding; warpgroup 1's last turn
  // opens none
  const int sl = (n - 1) % kStages;
  xlb::mbar_wait(v_full + 8 * sl, ((n - 1) / kStages) & 1);
  xlb::bar_sync(my_turn, kConsumers);
  xlb::reg_fence(o);
  xlb::wgmma_fence();
  mma_pv<HD, true>(o, pa, pr, v_at(sl));
  xlb::wgmma_commit();
  if (wg == 0) xlb::bar_arrive(other_turn, kConsumers);
  xlb::wgmma_wait<0>();
  xlb::reg_fence(o);

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  bf16* ob = static_cast<bf16*>(a.out) + b * a.osb + h * a.osh;
#pragma unroll
  for (int j = 0; j < HD / 2; j += 2) {
    const int i = (j >> 1) & 1, row = row_lo + 8 * i;
    if (row < S) {
      XLB_CHECK(b * a.osb + h * a.osh + (long long)row * a.oss +
                    8 * (j / 4) + col_lane + 1, a.no);
      *reinterpret_cast<__nv_bfloat162*>(
          ob + (long long)row * a.oss + 8 * (j / 4) + col_lane) =
          __floats2bfloat162_rn(o[j] * inv[i], o[j + 1] * inv[i]);
    }
  }
}

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// CUDA's tensor-map encoder, looked up through the runtime (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a bf16 (B, S, heads, hd) tensor with element strides
// (sb, ss, sh, 1), as (hd, heads, S, B), boxes of (PW, 1, rows, 1).  A dim
// of size 1 is never stepped, so its stride is replaced by a valid one.
int encode(CUtensorMap* map, const void* base, int B, int S, int heads,
           int hd, long long sb, long long ss, long long sh, int rows,
           int pw, int sw) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  if (heads == 1) sh = hd;
  if (S == 1) ss = sh * heads;
  if (B == 1) sb = ss * S;
  cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                           (cuuint64_t)sb * 2};
  cuuint32_t box[4] = {(cuuint32_t)pw, 1, (cuuint32_t)rows, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(base), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch(const FlashArgs& a, int B, cudaStream_t st) {
  using Gm = Geo<HD>;
  CUtensorMap mq, mk, mv;
  int err = encode(&mq, a.q, B, a.S, a.H, HD, a.qsb, a.qss, a.qsh, kBQ,
                   Gm::PW, Gm::SW);
  if (!err) err = encode(&mk, a.k, B, a.S, a.K, HD, a.ksb, a.kss, a.ksh, kBK,
                         Gm::PW, Gm::SW);
  if (!err) err = encode(&mv, a.v, B, a.S, a.K, HD, a.vsb, a.vss, a.vsh, kBK,
                         Gm::PW, Gm::SW);
  if (err) return err;
  const dim3 grid(B * a.H, (a.S + kBQ - 1) / kBQ);
  const cudaError_t e = xlb::allow_smem(flash_kernel_wgmma<HD>, Gm::SMEM);
  if (e != cudaSuccess) return (int)e;
  flash_kernel_wgmma<HD><<<grid, kThreads, Gm::SMEM, st>>>(mq, mk, mv, a);
  return (int)cudaGetLastError();
}

}  // namespace tc

int launch_hd(const FlashArgs& a, int B, int hd, int dtype,
              cudaStream_t st) {
  const bool f32 = dtype == xlb::kF32;
  switch (hd) {
    case 16: return f32 ? launch_fma<float, 16>(a, B, st)
                        : launch_fma<__nv_bfloat16, 16>(a, B, st);
    case 32: return f32 ? launch_fma<float, 32>(a, B, st)
                        : tc::launch<32>(a, B, st);
    case 64: return f32 ? launch_fma<float, 64>(a, B, st)
                        : tc::launch<64>(a, B, st);
    case 128: return f32 ? launch_fma<float, 128>(a, B, st)
                         : tc::launch<128>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int xlb_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int K, int hd, int dtype, int causal, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, float scale, void* stream) {
  if (K <= 0 || H % K != 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (dtype != xlb::kF32 && dtype != xlb::kBF16)
    return (int)cudaErrorInvalidValue;
  FlashArgs a{q, k, v, out, S, H, K, H / K, causal, qsb, qss, qsh, ksb, kss,
              ksh, vsb, vss, vsh, osb, oss, osh, scale};
#ifdef XLB_BOUNDS_CHECK
  // the last element of each strided view, plus one
  a.nq = (B - 1) * qsb + (S - 1) * qss + (H - 1) * qsh + hd;
  a.nk = (B - 1) * ksb + (S - 1) * kss + (K - 1) * ksh + hd;
  a.nv = (B - 1) * vsb + (S - 1) * vss + (K - 1) * vsh + hd;
  a.no = (B - 1) * osb + (S - 1) * oss + (H - 1) * osh + hd;
#endif
  return launch_hd(a, B, hd, dtype, static_cast<cudaStream_t>(stream));
}
