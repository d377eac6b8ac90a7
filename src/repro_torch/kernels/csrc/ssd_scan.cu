// Mamba-2 SSD scan (state-space duality, chunked form) for Hopper.
//
// Replaces: src/repro/kernels/ssd_scan.py::_ssd_kernel (behind
// ops.ssd_scan); semantics pinned by src/repro/models/ssm.py::ssd_chunked
// and src/repro/kernels/ref.py::ssd_scan_ref.  Per (sequence, head), with
// x = dt * x (S, hd), a = dt * A (S,), B and C (S, N) and the state h
// (hd, N) f32 starting at zero:
//   y_l = sum_{s <= l} (C_l . B_s) exp(A_l - A_s) x_s + exp(A_l) h C_l
//   h  <- exp(A_last) h + sum_s exp(A_last - A_s) x_s B_s^T
// over consecutive chunks, A being the running sum of a inside the chunk.
// The form is exact for any chunk length, so the kernels use their own
// whatever the model's.  Besides y (S, hd) they write the final state
// h_last (hd, N) f32, which decode after prefill needs and the Pallas
// kernel keeps only in scratch.  Inputs are read through their strides, so
// B and C may be views broadcast over the heads (stride 0), as the model
// passes its n_groups = 1 projections.  Any S > 0; the tail is masked.
//
// What bounds it: bytes.  At mamba2-2.7b's prefill (2 x 4096 rows, 80
// heads of hd 64, N 128, bf16) the function reads and writes about 180 MB
// and does about 30 GFLOP in the 64-row form: 0.054 ms at 3.35 TB/s
// against 0.03 ms at the bf16 tensor-core rate.
//
// bf16: four chunk-parallel passes over chunks of kQ = 256 rows, their
// products on the tensor cores (mma.sync.m16n8k16, bf16 operands, f32
// accumulators), all state in f32:
//   ssd_chunk_state  grid (head, chunk, sequence): the running sum of a
//     (written to scratch for the other passes) and the chunk's own state
//     s_c = sum_s exp(A_last - A_s) x_s B_s^T = (w x)^T B, the decay
//     folded into x in f32;
//   ssd_scores       grid (64 x 64 tile, chunk, sequence), only when B and
//     C are shared by every head (head stride 0): the causal tiles of
//     C B^T in f32, computed once for all the heads instead of once per
//     head (the scan pass reads them from L2 for every head);
//   ssd_state_pass   grid (state entries, head, sequence): the one
//     sequential step, h_c = exp(A_c) h_{c-1} + s_c over the chunks in
//     f32, writing h_{c-1} rounded to bf16 (the operand the scan pass
//     needs) and h_last in f32 at the end;
//   ssd_chunk_scan   grid (head, chunk, sequence), 64-row sub-tiles:
//     y = exp(A_r) (C h_prev^T) + ((C B^T) * exp(A_r - A_s), s <= r) x,
//     the masked scores split into two bf16 terms in registers as the A
//     operand of the second product; C B^T read from ssd_scores' output
//     (f32), or (B and C per head) computed in the block.
// Precision: w x enters as three bf16 terms that sum to it in f32, so the
// states and h_last are f32-exact sums; the masked scores enter G x as two
// bf16 terms (a long sum of nearly cancelling terms, where a decay is near
// 1, would otherwise miss y's bf16 tolerance); only h_prev is rounded to
// bf16, for the term exp(A_r) C h_prev^T that decays along the chunk.
//
// hd 16 or N 16 (the reference's smoke configs), f32 and bf16: ssd_kernel
// below, instantiated for both types (bf16 loads widened to f32, all
// arithmetic in f32).  The passes' warp tiling needs at least 32 columns
// of the state; the FMA kernel takes any multiple of 16.
//
// f32: ssd_kernel, f32 FMAs on the CUDA cores (TF32 would miss the 2e-5
// the f32 build is held to): one block of 256 threads per (sequence,
// head) walks 64-row tiles in order, the state h in shared memory for the
// whole walk (rows padded by one float against bank conflicts; about
// 130 KB at hd = 64, N = 128, so the launch opts in above 48 KB).  Warp 0
// takes the running sum of a with shuffles.  Thread (ty, tx) of a 16 x 16
// grid computes a 4 x 4 patch of the masked scores, then rows ty + 16 i,
// columns tx + 16 j of y, then state entries (ty + 16 i, tx + 16 j).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>

#include "float_io.cuh"
#include "hopper.cuh"

namespace {

using xlb::from_f32;
using xlb::to_f32;

constexpr int kThreads = 256;
constexpr int kT = 64;           // rows per tile of the f32 kernel

struct SSDArgs {
  const void *x, *b, *c;
  const float* a;
  void* y;
  float* h_last;
  int S, nh;
  long long xsb, xss, xsh;
  long long asb, ass, ash;
  long long bsb, bss, bsh;
  long long csb, css, csh;
  // scratch of the bf16 passes (see scratch_floats)
  int nc;                        // chunks per sequence
  float* acum;                   // (B, nh, nc, kQ) running sums of a
  float* states;                 // (B, nh, nc, hd, N) s_c
  __nv_bfloat16* hprev;          // (B, nh, nc, hd, N) h_{c-1} in bf16
  float4* scores;                // (B, nc, kSub, kSub) tiles of C B^T in
                                 // fragment order, when shared
};

template <int HD, int N>
constexpr int f32_smem_bytes() {
  return (int)sizeof(float) * (kT * HD + kT * (N + 1) + kT * N +
                               kT * (kT + 1) + HD * (N + 1) + 2 * kT);
}

template <typename T, int HD, int N>
__global__ void __launch_bounds__(kThreads) ssd_kernel(SSDArgs a) {
  constexpr int kP = HD / 16;              // state / output columns
  constexpr int kN = N / 16;
  extern __shared__ float smem[];
  float* x_s = smem;                       // (kT, HD)
  float* b_s = x_s + kT * HD;              // (kT, N + 1)
  float* c_s = b_s + kT * (N + 1);         // (kT, N)
  float* g_s = c_s + kT * N;               // (kT, kT + 1) masked scores
  float* h_s = g_s + kT * (kT + 1);        // (HD, N + 1) state
  float* acum = h_s + HD * (N + 1);        // (kT,) running sum of a
  float* w_s = acum + kT;                  // (kT,) exp(A_last - A_s)

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x, b = bh / a.nh, h = bh % a.nh;
  const T* xb = static_cast<const T*>(a.x) + b * a.xsb + h * a.xsh;
  const T* bb = static_cast<const T*>(a.b) + b * a.bsb + h * a.bsh;
  const T* cb = static_cast<const T*>(a.c) + b * a.csb + h * a.csh;
  const float* ab = a.a + b * a.asb + h * a.ash;
  T* yb = static_cast<T*>(a.y) + ((long long)b * a.S * a.nh + h) * HD;
  const long long ys = (long long)a.nh * HD;

  for (int i = tid; i < HD * (N + 1); i += kThreads) h_s[i] = 0.f;

  for (int t0 = 0; t0 < a.S; t0 += kT) {
    __syncthreads();                       // the last tile's readers are done
    for (int i = tid; i < kT * HD; i += kThreads) {
      const int r = i / HD, p = i % HD;
      x_s[i] = t0 + r < a.S ? to_f32(xb[(long long)(t0 + r) * a.xss + p])
                            : 0.f;
    }
    for (int i = tid; i < kT * N; i += kThreads) {
      const int r = i / N, n = i % N;
      const bool in = t0 + r < a.S;
      const long long s = t0 + r;
      b_s[r * (N + 1) + n] = in ? to_f32(bb[s * a.bss + n]) : 0.f;
      c_s[i] = in ? to_f32(cb[s * a.css + n]) : 0.f;
    }
    if (tid < kT)
      w_s[tid] = t0 + tid < a.S ? ab[(long long)(t0 + tid) * a.ass] : 0.f;
    __syncthreads();
    if (tid < 32) {                        // inclusive scan of a over kT = 64
      float v0 = w_s[tid], v1 = w_s[tid + 32];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, o);
        if (tid >= o) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      acum[tid] = v0;
      acum[tid + 32] = v1;
    }
    __syncthreads();
    const float a_last = acum[kT - 1];     // tail rows add a = 0
    if (tid < kT) w_s[tid] = expf(a_last - acum[tid]);

    // masked scores G = (C B^T) * exp(A_r - A_c), c <= r
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * N + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[(tx + 16 * j) * (N + 1) + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += cv[i] * bv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        g_s[r * (kT + 1) + c] =
            c <= r ? s[i][j] * expf(acum[r] - acum[c]) : 0.f;
      }
    }
    __syncthreads();

    // y = G x + exp(A_r) C h^T
    float yd[4][kP], yo[4][kP];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int p = 0; p < kP; ++p) yd[i][p] = yo[i][p] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      float gv[4], xv[kP];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = g_s[(ty + 16 * i) * (kT + 1) + j];
#pragma unroll
      for (int p = 0; p < kP; ++p) xv[p] = x_s[j * HD + tx + 16 * p];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int p = 0; p < kP; ++p) yd[i][p] += gv[i] * xv[p];
    }
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[4], hv[kP];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * N + n];
#pragma unroll
      for (int p = 0; p < kP; ++p) hv[p] = h_s[(tx + 16 * p) * (N + 1) + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int p = 0; p < kP; ++p) yo[i][p] += cv[i] * hv[p];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (t0 + r < a.S) {
        const float e = expf(acum[r]);
#pragma unroll
        for (int p = 0; p < kP; ++p)
          yb[(long long)(t0 + r) * ys + tx + 16 * p] =
              from_f32<T>(yd[i][p] + e * yo[i][p]);
      }
    }
    __syncthreads();                       // every read of h is done

    // h <- exp(A_last) h + sum_s w_s x_s B_s^T
    const float decay = expf(a_last);
    float hn[kP][kN];
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int n = 0; n < kN; ++n) hn[p][n] = 0.f;
#pragma unroll 2
    for (int j = 0; j < kT; ++j) {
      const float wj = w_s[j];
      float xv[kP], bv[kN];
#pragma unroll
      for (int p = 0; p < kP; ++p) xv[p] = x_s[j * HD + ty + 16 * p] * wj;
#pragma unroll
      for (int n = 0; n < kN; ++n) bv[n] = b_s[j * (N + 1) + tx + 16 * n];
#pragma unroll
      for (int p = 0; p < kP; ++p)
#pragma unroll
        for (int n = 0; n < kN; ++n) hn[p][n] += xv[p] * bv[n];
    }
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        float* cell = &h_s[(ty + 16 * p) * (N + 1) + tx + 16 * n];
        *cell = decay * *cell + hn[p][n];
      }
  }
  __syncthreads();
  float* hl = a.h_last + (long long)bh * HD * N;
  for (int i = tid; i < HD * N; i += kThreads)
    hl[i] = h_s[(i / N) * (N + 1) + i % N];
}


// --------------------------------------------------------------------------
// bf16: chunk-parallel passes on the tensor cores
// --------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using xlb::smem_u32;

constexpr int kQ = 256;          // rows per chunk
constexpr int kR = 64;           // rows per sub-tile
constexpr int kSub = kQ / kR;
constexpr int kPairs = kSub * (kSub + 1) / 2;   // causal sub-tile pairs
constexpr int kPass = 128;       // threads of a chunk block: 4 warps
constexpr int kStateThreads = 256;
constexpr int kPad = 8;          // bf16 of padding per shared row
constexpr float kLog2e = 1.4426950408889634f;

constexpr long long nchunks(int S) { return (S + kQ - 1) / kQ; }

// B and C are one group shared by every head: C B^T is the same for all
__host__ __device__ constexpr bool shared_bc(long long bsh, long long csh,
                                             int nh) {
  return nh == 1 || (bsh == 0 && csh == 0);
}

// 2^x (MUFU, flushes subnormal results to 0): decays and scores that are
// rounded to bf16 next
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Start copying ROWS rows of COLS bf16 (row stride `rs` elements) into
// shared rows of COLS + kPad with cp.async; rows from `valid` on are
// zero-filled and read nothing (`safe` is any readable address).  The
// caller commits and waits.
template <int COLS, int ROWS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          long long rs, long long valid,
                                          const bf16* safe, int tid) {
  constexpr int kV = COLS / 8;
  static_assert(ROWS * kV % kPass == 0, "whole rounds of 16-byte copies");
#pragma unroll
  for (int it = 0; it < ROWS * kV / kPass; ++it) {
    const int i = tid + it * kPass, r = i / kV, q = i % kV;
    const bool ok = r < valid;
    xlb::cp_async16(smem_u32(dst + r * (COLS + kPad) + 8 * q),
                    ok ? src + r * rs + 8 * q : safe, ok);
  }
}

// a_s <- the running sum of a over the chunk's kQ rows from row s0 (a = 0
// past S); ends on a barrier.
__device__ void chunk_cumsum(float* a_s, const float* ab, long long ass,
                             long long s0, int S, int tid) {
  for (int i = tid; i < kQ; i += kPass)
    a_s[i] = s0 + i < S ? ab[(s0 + i) * ass] : 0.f;
  __syncthreads();
  if (tid < 32) {
    constexpr int kE = kQ / 32;
    float v[kE], run = 0.f;
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      run += a_s[kE * tid + k];
      v[k] = run;
    }
    float inc = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, inc, o);
      if (tid >= o) inc += u;
    }
#pragma unroll
    for (int k = 0; k < kE; ++k) a_s[kE * tid + k] = v[k] + inc - run;
  }
  __syncthreads();
}

// sc += C B^T for the warp's 16 rows of `cs` against the 64 rows of `bs`
// (both (rows, N + kPad) bf16 in shared memory): eight 16 x 8 tiles.
template <int N>
__device__ __forceinline__ void scores_tile(float (&sc)[8][4], const bf16* cs,
                                            const bf16* bs, int warp,
                                            int lane) {
  const int j8 = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t af[4];
    xlb::ldsm_x4(af, smem_u32(cs + (warp * 16 + (lane & 15)) * (N + kPad) +
                              kk * 16 + 8 * (lane >> 4)));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      xlb::ldsm_x4(bf, smem_u32(bs + (np * 16 + r8 + 8 * (j8 >> 1)) *
                                         (N + kPad) + kk * 16 + 8 * (j8 & 1)));
      xlb::mma_bf16(sc[2 * np], af, bf[0], bf[1]);
      xlb::mma_bf16(sc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// Warps of a chunk block over the (HD, N) state: WM along hd, WN along N.
template <int HD, int N>
struct StateTiles {
  static constexpr int WM = HD / 16 < 4 ? HD / 16 : 4;
  static constexpr int WN = 4 / WM;
  static constexpr int MT = HD / 16 / WM;   // 16-row tiles of a warp
  static constexpr int NT = N / 8 / WN;     // 8-column tiles of a warp
};

// w x enters the tensor cores as kSplit bf16 terms whose sum is w x to f32
// precision
constexpr int kSplit = 3;

template <int HD, int N>
constexpr int state_smem() {
  return 2 * kQ * 4 + 2 * kR * (HD + kPad) * 2 + 2 * kR * (N + kPad) * 2;
}

// Pass 1: the running sum of a (to scratch) and the chunk's own state
// s_c = (w x)^T B, w = exp(A_last - A_s).  The chunk's x and B arrive by
// cp.async, 64 rows at a time, through a ring of two buffers.  x is
// read raw from shared memory into A fragments; w x is formed there in f32
// and enters the tensor cores as three bf16 terms (hi, the rounding of what
// hi leaves, the rest), each product with B exact in f32, so s_c, and with
// it h_last, is as exact as an f32 sum: the f32 output h_last is held to
// f32 tolerances.
template <int HD, int N>
__global__ void __launch_bounds__(kPass) ssd_chunk_state(SSDArgs a) {
  using W = StateTiles<HD, N>;
  extern __shared__ __align__(16) unsigned char pass_smem[];
  float* a_s = reinterpret_cast<float*>(pass_smem);   // (kQ,) A
  float* w_s = a_s + kQ;                              // (kQ,) exp(A_last - A)
  bf16* xs = reinterpret_cast<bf16*>(w_s + kQ);       // 2 x (kR, HD + kPad)
  bf16* bs = xs + 2 * kR * (HD + kPad);               // 2 x (kR, N + kPad)
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const long long s0 = (long long)c * kQ, bh = (long long)b * a.nh + h;
  const bf16* xb = static_cast<const bf16*>(a.x) + b * a.xsb + h * a.xsh;
  const bf16* bb = static_cast<const bf16*>(a.b) + b * a.bsb + h * a.bsh;
  auto fetch = [&](int kt) {                // tile kt into buffer kt % 2
    const long long r0 = s0 + kt * kR;
    copy_rows<HD, kR>(xs + (kt % 2) * kR * (HD + kPad), xb + r0 * a.xss,
                      a.xss, a.S - r0, xb, tid);
    copy_rows<N, kR>(bs + (kt % 2) * kR * (N + kPad), bb + r0 * a.bss,
                     a.bss, a.S - r0, bb, tid);
    xlb::cp_async_commit();
  };
  fetch(0);
  fetch(1);
  chunk_cumsum(a_s, a.a + b * a.asb + h * a.ash, a.ass, s0, a.S, tid);
  float* acum = a.acum + (bh * a.nc + c) * kQ;
  const float a_last = a_s[kQ - 1];
  for (int i = tid; i < kQ; i += kPass) {
    acum[i] = a_s[i];
    w_s[i] = expf(a_last - a_s[i]);
  }

  const int wm = warp % W::WM, wn = warp / W::WM;
  const int j8 = lane >> 3, r8 = lane & 7, tq = lane & 3;
  float acc[W::MT][W::NT][4];
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int kt = 0; kt < kSub; ++kt) {
    xlb::cp_async_wait(kt + 1 < kSub ? 1 : 0);   // tile kt has landed
    __syncthreads();
    const bf16* xt = xs + (kt % 2) * kR * (HD + kPad);
    const bf16* bt = bs + (kt % 2) * kR * (N + kPad);
#pragma unroll
    for (int kk = 0; kk < kR / 16; ++kk) {
      const int k0 = kk * 16;
      // w at this lane's fragment rows: k0 + 2 tq (+1) and k0 + 8 + 2 tq (+1)
      const float* wt = w_s + kt * kR + k0 + 2 * tq;
      const float2 wl = *reinterpret_cast<const float2*>(wt);
      const float2 wh = *reinterpret_cast<const float2*>(wt + 8);
      uint32_t af[kSplit][W::MT][4];         // (w x)^T: x stored (s, p)
#pragma unroll
      for (int i = 0; i < W::MT; ++i) {
        uint32_t raw[4];
        xlb::ldsm_x4_t(raw, smem_u32(xt + (k0 + r8 + 8 * (j8 >> 1)) *
                                              (HD + kPad) +
                                     (wm * W::MT + i) * 16 + 8 * (j8 & 1)));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 w = r < 2 ? wl : wh;
          float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&raw[r]));
          f.x *= w.x;
          f.y *= w.y;
#pragma unroll
          for (int k = 0; k < kSplit; ++k) {   // f = the sum of the terms
            const __nv_bfloat162 t = __floats2bfloat162_rn(f.x, f.y);
            af[k][i][r] = *reinterpret_cast<const uint32_t*>(&t);
            const float2 tf = __bfloat1622float2(t);
            f.x -= tf.x;
            f.y -= tf.y;
          }
        }
      }
#pragma unroll
      for (int np = 0; np < W::NT / 2; ++np) {
        uint32_t bf[4];                      // B: stored (s, n)
        xlb::ldsm_x4_t(bf, smem_u32(bt + (k0 + r8 + 8 * (j8 & 1)) *
                                             (N + kPad) +
                                    (wn * W::NT + 2 * np) * 8 + 8 * (j8 >> 1)));
#pragma unroll
        for (int k = kSplit - 1; k >= 0; --k)   // the small terms first
#pragma unroll
          for (int i = 0; i < W::MT; ++i) {
            xlb::mma_bf16(acc[i][2 * np], af[k][i], bf[0], bf[1]);
            xlb::mma_bf16(acc[i][2 * np + 1], af[k][i], bf[2], bf[3]);
          }
      }
    }
    if (kt + 2 < kSub) {
      __syncthreads();                       // every read of this buffer
      fetch(kt + 2);
    }
  }
  float* st = a.states + (bh * a.nc + c) * HD * N;
  const int g = lane >> 2;
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j) {
      const int p = (wm * W::MT + i) * 16 + g, n = (wn * W::NT + j) * 8 + 2 * tq;
      *reinterpret_cast<float2*>(st + p * N + n) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(st + (p + 8) * N + n) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

template <int N>
constexpr int scores_smem() { return 2 * kR * (N + kPad) * 2; }

// float4 offset of score tile (t, j) of chunk c of sequence b: 1024 each
__device__ __forceinline__ long long score_tile(int b, int nc, int c, int t,
                                                int j) {
  return (((long long)b * nc + c) * kSub * kSub + t * kSub + j) * 1024;
}

// Pass 2 (B and C shared by the heads): the causal 64 x 64 tiles (t, j),
// j <= t, of C B^T for each chunk in f32, stored in the order of the
// accumulator fragments: in tile (t, j), warp w's lane l keeps its eight
// float4 (rows 16 w + l / 4 and 8 below, a column pair each) 32 float4
// apart, so that chunk_scan's warp reads its rows of a tile as eight
// coalesced 512-byte loads.
template <int N>
__global__ void __launch_bounds__(kPass) ssd_scores(SSDArgs a) {
  extern __shared__ __align__(16) unsigned char pass_smem[];
  bf16* cs = reinterpret_cast<bf16*>(pass_smem);      // (kR, N + kPad)
  bf16* bs = cs + kR * (N + kPad);                    // (kR, N + kPad)
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int t = 0, j = blockIdx.x;
  while (j > t) j -= ++t;
  const int c = blockIdx.y, b = blockIdx.z;
  const long long rt = (long long)c * kQ + t * kR;
  const long long rj = (long long)c * kQ + j * kR;
  if (rt >= a.S) return;
  const bf16* cb = static_cast<const bf16*>(a.c) + b * a.csb;
  const bf16* bb = static_cast<const bf16*>(a.b) + b * a.bsb;
  copy_rows<N, kR>(cs, cb + rt * a.css, a.css, a.S - rt, cb, tid);
  copy_rows<N, kR>(bs, bb + rj * a.bss, a.bss, a.S - rj, bb, tid);
  xlb::cp_async_commit();
  xlb::cp_async_wait(0);
  __syncthreads();
  float sc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
  scores_tile<N>(sc, cs, bs, warp, lane);
  float4* out = a.scores + score_tile(b, a.nc, c, t, j) + warp * 256 + lane;
#pragma unroll
  for (int n = 0; n < 8; ++n)
    out[32 * n] = make_float4(sc[n][0], sc[n][1], sc[n][2], sc[n][3]);
}

// Pass 3: h_c = exp(A_c) h_{c-1} + s_c over the chunks in order, four
// state entries a thread, in f32; h_{c-1} is written in bf16 for the scan
// pass, h_last in f32.  The loads of up to kBatch chunks are issued before
// the walk over them.
constexpr int kBatch = 16;

template <int HD, int N>
__global__ void __launch_bounds__(kStateThreads) ssd_state_pass(SSDArgs a) {
  const int e = (blockIdx.x * kStateThreads + threadIdx.x) * 4;
  if (e >= HD * N) return;
  const long long bh = (long long)blockIdx.z * a.nh + blockIdx.y;
  const float* st = a.states + bh * a.nc * HD * N + e;
  bf16* hp = a.hprev + bh * a.nc * HD * N + e;
  const float* tot = a.acum + bh * a.nc * kQ + kQ - 1;   // A of each chunk
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < a.nc; c0 += kBatch) {
    float4 s[kBatch];
    float d[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (c0 + i < a.nc) {
        s[i] = *reinterpret_cast<const float4*>(st + (long long)(c0 + i) * HD * N);
        d[i] = tot[(long long)(c0 + i) * kQ];
      }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (c0 + i < a.nc) {
        *reinterpret_cast<uint2*>(hp + (long long)(c0 + i) * HD * N) =
            make_uint2(pack_bf16(h.x, h.y), pack_bf16(h.z, h.w));
        const float dc = expf(d[i]);
        h = make_float4(dc * h.x + s[i].x, dc * h.y + s[i].y,
                        dc * h.z + s[i].z, dc * h.w + s[i].w);
      }
  }
  *reinterpret_cast<float4*>(a.h_last + bh * HD * N + e) = h;
}

// G enters G x as two bf16 terms that sum to it to 2^-16: in a long sum
// of nearly cancelling terms (a decay near 1) one bf16 rounding of G
// costs as much as the bf16 tolerance of y
constexpr int kGSplit = 2;

template <int HD, int N, bool kShared>
constexpr int scan_smem() {
  return kQ * 4 + kQ * (HD + kPad) * 2 + HD * (N + kPad) * 2 +
         kR * (N + kPad) * 2 + (kShared ? 0 : kQ * (N + kPad) * 2);
}

// Pass 4: y of a chunk for one head, 64 rows at a time; each of the four
// warps takes 16 rows: acc = exp(A_r) (C h_prev^T), then for each 64-row
// tile jt <= t of earlier rows acc += G x with G = (C B^T) exp(A_r - A_s)
// at s <= r, split into two bf16 terms in registers as the A fragments.
// x (and B) of the chunk arrive by cp.async in kSub groups taken in turn,
// h_prev (bf16) with the first, C a tile at a time into one buffer.
template <int HD, int N, bool kShared>
__global__ void __launch_bounds__(kPass) ssd_chunk_scan(SSDArgs a) {
  extern __shared__ __align__(16) unsigned char pass_smem[];
  float* ac = reinterpret_cast<float*>(pass_smem);    // (kQ,) A in log2 units
  bf16* xs = reinterpret_cast<bf16*>(ac + kQ);        // (kQ, HD + kPad)
  bf16* hs = xs + kQ * (HD + kPad);                   // (HD, N + kPad) h_prev
  bf16* cs = hs + HD * (N + kPad);                    // (kR, N + kPad)
  bf16* bs = cs + kR * (N + kPad);                    // (kQ, N + kPad) !kShared
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const long long s0 = (long long)c * kQ, bh = (long long)b * a.nh + h;
  const int rows = (int)min((long long)kQ, a.S - s0);
  const bf16* xb = static_cast<const bf16*>(a.x) + b * a.xsb + h * a.xsh;
  const bf16* bb = static_cast<const bf16*>(a.b) + b * a.bsb + h * a.bsh;
  const bf16* cb = static_cast<const bf16*>(a.c) + b * a.csb + h * a.csh;
  for (int t = 0; t < kSub; ++t) {
    const long long r0 = s0 + t * kR;
    copy_rows<HD, kR>(xs + t * kR * (HD + kPad), xb + r0 * a.xss, a.xss,
                      a.S - r0, xb, tid);
    if constexpr (!kShared)
      copy_rows<N, kR>(bs + t * kR * (N + kPad), bb + r0 * a.bss, a.bss,
                       a.S - r0, bb, tid);
    if (t == 0) {
      const bf16* hp = a.hprev + (bh * a.nc + c) * HD * N;
      copy_rows<N, HD>(hs, hp, N, HD, hp, tid);
      copy_rows<N, kR>(cs, cb + r0 * a.css, a.css, a.S - r0, cb, tid);
    }
    xlb::cp_async_commit();
  }
  const float* acum = a.acum + (bh * a.nc + c) * kQ;
  for (int i = tid; i < kQ; i += kPass) ac[i] = acum[i] * kLog2e;
  const int g = lane >> 2, tq = lane & 3, j8 = lane >> 3, r8 = lane & 7;
  const long long ys = (long long)a.nh * HD;          // y is (B, S, nh, HD)
  bf16* yb = static_cast<bf16*>(a.y) + ((long long)b * a.S + s0) * ys +
             (long long)h * HD;

  for (int t = 0; t < kSub; ++t) {
    // x of tile t, and C of tile t: in group 0, later in the last group
    xlb::cp_async_wait(t == 0 ? kSub - 1 : 0);
    __syncthreads();
    if (t * kR < rows) {
      const int r0 = t * kR + warp * 16 + g, r1 = r0 + 8;
      // shared scores: this warp's rows of tile (t, jt), the next tile's
      // loads in flight while a tile is used
      const float4* sp = a.scores + score_tile(b, a.nc, c, t, 0) +
                         warp * 256 + lane;
      auto load_scores = [&](float4 (&sv)[8], int jt) {
#pragma unroll
        for (int n = 0; n < 8; ++n) sv[n] = sp[jt * 1024 + 32 * n];
      };
      float4 sv[8], nx[8];
      if constexpr (kShared) load_scores(sv, 0);
      float acc[HD / 8][4];
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {   // C h_prev^T
        uint32_t af[4];
        xlb::ldsm_x4(af, smem_u32(cs + (warp * 16 + (lane & 15)) * (N + kPad) +
                                  kk * 16 + 8 * (lane >> 4)));
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bf[4];
          xlb::ldsm_x4(bf, smem_u32(hs + (np * 16 + r8 + 8 * (j8 >> 1)) *
                                             (N + kPad) +
                                    kk * 16 + 8 * (j8 & 1)));
          xlb::mma_bf16(acc[2 * np], af, bf[0], bf[1]);
          xlb::mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
        }
      }
      const float A0 = ac[r0], A1 = ac[r1];
      const float e0 = ex2(A0), e1 = ex2(A1);
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        acc[i][0] *= e0;
        acc[i][1] *= e0;
        acc[i][2] *= e1;
        acc[i][3] *= e1;
      }
      for (int jt = 0; jt <= t; ++jt) {
        float sf[8][4];                       // C B^T of tile jt, rows r0 / r1
        if constexpr (kShared) {
          if (jt < t) load_scores(nx, jt + 1);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            sf[n][0] = sv[n].x;
            sf[n][1] = sv[n].y;
            sf[n][2] = sv[n].z;
            sf[n][3] = sv[n].w;
          }
        } else {
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sf[n][e] = 0.f;
          scores_tile<N>(sf, cs, bs + jt * kR * (N + kPad), warp, lane);
        }
        const bool diag = jt == t;            // only there is s > r
        uint32_t gf[kGSplit][4][4];           // G as A fragments (k = s)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int n = 2 * kk + half, s = jt * kR + 8 * n + 2 * tq;
            const float As0 = ac[s], As1 = ac[s + 1];
            float g00 = sf[n][0] * ex2(A0 - As0), g01 = sf[n][1] * ex2(A0 - As1);
            float g10 = sf[n][2] * ex2(A1 - As0), g11 = sf[n][3] * ex2(A1 - As1);
            if (diag) {
              g00 = s <= r0 ? g00 : 0.f;
              g01 = s + 1 <= r0 ? g01 : 0.f;
              g10 = s <= r1 ? g10 : 0.f;
              g11 = s + 1 <= r1 ? g11 : 0.f;
            }
#pragma unroll
            for (int k = 0; k < kGSplit; ++k) {   // g = the sum of the terms
              const __nv_bfloat162 t0 = __floats2bfloat162_rn(g00, g01);
              const __nv_bfloat162 t1 = __floats2bfloat162_rn(g10, g11);
              gf[k][kk][2 * half] = *reinterpret_cast<const uint32_t*>(&t0);
              gf[k][kk][2 * half + 1] =
                  *reinterpret_cast<const uint32_t*>(&t1);
              const float2 u = __bfloat1622float2(t0);
              const float2 v = __bfloat1622float2(t1);
              g00 -= u.x;
              g01 -= u.y;
              g10 -= v.x;
              g11 -= v.y;
            }
          }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int np = 0; np < HD / 16; ++np) {
            uint32_t bf[4];                   // x: stored (s, p)
            xlb::ldsm_x4_t(bf, smem_u32(xs + (jt * kR + kk * 16 + r8 +
                                              8 * (j8 & 1)) * (HD + kPad) +
                                        np * 16 + 8 * (j8 >> 1)));
#pragma unroll
            for (int k = kGSplit - 1; k >= 0; --k) {
              xlb::mma_bf16(acc[2 * np], gf[k][kk], bf[0], bf[1]);
              xlb::mma_bf16(acc[2 * np + 1], gf[k][kk], bf[2], bf[3]);
            }
          }
        if constexpr (kShared) {
          if (jt < t)
#pragma unroll
            for (int n = 0; n < 8; ++n) sv[n] = nx[n];
        }
      }
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const int p = 8 * i + 2 * tq;
        if (r0 < rows)
          *reinterpret_cast<__nv_bfloat162*>(yb + r0 * ys + p) =
              __floats2bfloat162_rn(acc[i][0], acc[i][1]);
        if (r1 < rows)
          *reinterpret_cast<__nv_bfloat162*>(yb + r1 * ys + p) =
              __floats2bfloat162_rn(acc[i][2], acc[i][3]);
      }
    }
    if (t + 1 < kSub) {
      __syncthreads();                        // every read of C's buffer
      const long long r0 = s0 + (t + 1) * kR;
      copy_rows<N, kR>(cs, cb + r0 * a.css, a.css, a.S - r0, cb, tid);
      xlb::cp_async_commit();
    }
  }
}

template <int HD, int N, bool kShared>
int launch_passes(const SSDArgs& a, int B, cudaStream_t st) {
  constexpr int s1 = state_smem<HD, N>(), s3 = scan_smem<HD, N, kShared>();
  cudaError_t err = xlb::allow_smem(ssd_chunk_state<HD, N>, s1);
  if (err == cudaSuccess)
    err = xlb::allow_smem(ssd_chunk_scan<HD, N, kShared>, s3);
  if (err != cudaSuccess) return (int)err;
  const dim3 chunks(a.nh, a.nc, B);
  ssd_chunk_state<HD, N><<<chunks, kPass, s1, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (kShared) {
    ssd_scores<N><<<dim3(kPairs, a.nc, B), kPass, scores_smem<N>(), st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  constexpr int kStateBlocks = (HD * N / 4 + kStateThreads - 1) / kStateThreads;
  ssd_state_pass<HD, N><<<dim3(kStateBlocks, a.nh, B), kStateThreads, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_chunk_scan<HD, N, kShared><<<chunks, kPass, s3, st>>>(a);
  return (int)cudaGetLastError();
}

// bf16 runs the FMA kernel where hd or N is 16
__host__ __device__ constexpr bool fma_bf16(int hd, int n) {
  return hd == 16 || n == 16;
}

template <typename T, int HD, int N>
int launch_fma(const SSDArgs& a, int B, cudaStream_t st) {
  constexpr int smem = f32_smem_bytes<HD, N>();
  cudaError_t err = xlb::allow_smem(ssd_kernel<T, HD, N>, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<T, HD, N><<<B * a.nh, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int HD, int N>
int launch(const SSDArgs& a, int B, int dtype, cudaStream_t st) {
  if (dtype == xlb::kF32) return launch_fma<float, HD, N>(a, B, st);
  if constexpr (fma_bf16(HD, N)) {
    return launch_fma<bf16, HD, N>(a, B, st);
  } else {
    return shared_bc(a.bsh, a.csh, a.nh)
               ? launch_passes<HD, N, true>(a, B, st)
               : launch_passes<HD, N, false>(a, B, st);
  }
}

template <int HD>
int launch_n(const SSDArgs& a, int B, int n, int dtype, cudaStream_t st) {
  switch (n) {
    case 16: return launch<HD, 16>(a, B, dtype, st);
    case 32: return launch<HD, 32>(a, B, dtype, st);
    case 64: return launch<HD, 64>(a, B, dtype, st);
    case 128: return launch<HD, 128>(a, B, dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of scratch one xlb_ssd_scan call needs (0 for f32): the running
// sums of a, the chunk states and, where B and C are shared by the heads,
// the scores C B^T of each chunk.
extern "C" long long xlb_ssd_scratch_floats(int B, int S, int nh, int hd,
                                            int n, int dtype, long long bsh,
                                            long long csh) {
  if (dtype != xlb::kBF16 || S <= 0 || fma_bf16(hd, n)) return 0;
  const long long nc = nchunks(S);
  // acum, states, and h_prev in bf16 (half a float an entry)
  long long f = (long long)B * nh * nc * (kQ + (long long)hd * n * 3 / 2);
  if (shared_bc(bsh, csh, nh)) f += (long long)B * nc * kQ * kQ;
  return f;
}

extern "C" int xlb_ssd_scan(
    const void* x, const float* a_log, const void* b, const void* c,
    void* y, float* h_last, float* scratch, int B, int S, int nh, int hd,
    int n, int dtype, long long xsb, long long xss, long long xsh,
    long long asb, long long ass, long long ash, long long bsb,
    long long bss, long long bsh, long long csb, long long css,
    long long csh, void* stream) {
  if (S <= 0 || (dtype != xlb::kF32 && dtype != xlb::kBF16))
    return (int)cudaErrorInvalidValue;
  SSDArgs a{x, b, c, a_log, y, h_last, S, nh, xsb, xss, xsh, asb, ass, ash,
            bsb, bss, bsh, csb, css, csh};
  a.nc = (int)nchunks(S);
  a.acum = scratch;
  a.states = scratch + (long long)B * nh * a.nc * kQ;
  a.hprev = reinterpret_cast<bf16*>(a.states +
                                    (long long)B * nh * a.nc * hd * n);
  a.scores = reinterpret_cast<float4*>(a.states +
                                       (long long)B * nh * a.nc * hd * n * 3 / 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_n<16>(a, B, n, dtype, st);
    case 32: return launch_n<32>(a, B, n, dtype, st);
    case 64: return launch_n<64>(a, B, n, dtype, st);
    case 128: return launch_n<128>(a, B, n, dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
