// Mamba-2 SSD scan (state-space duality, chunked form) for Hopper.
//
// Replaces: src/repro/kernels/ssd_scan.py::_ssd_kernel (behind
// ops.ssd_scan); semantics pinned by src/repro/models/ssm.py::ssd_chunked
// and src/repro/kernels/ref.py::ssd_scan_ref.  Per (sequence, head), with
// x = dt * x (S, hd), a = dt * A (S,), B and C (S, N) and the state h
// (hd, N) f32 starting at zero:
//   y_l = sum_{s <= l} (C_l . B_s) exp(A_l - A_s) x_s + exp(A_l) h C_l
//   h  <- exp(A_last) h + sum_s exp(A_last - A_s) x_s B_s^T
// over consecutive tiles, A being the running sum of a inside the tile.
// The form is exact for any tile length, so the kernel uses its own tile
// of kT = 64 rows whatever the model's chunk (256 for mamba2-2.7b, whose
// f32 B, C and 256 x 256 scores would not fit a block's shared memory),
// and costs fewer operations per row than a 256-row chunk.  Besides y
// (S, hd) it writes the final state h_last (hd, N) f32, which decode after
// prefill needs and the Pallas kernel keeps only in scratch.
//
// What bounds it: operations at these shapes (four products of a 64-row
// tile with N = 128 and hd = 64 per 64 rows) against about 180 MB of
// inputs and outputs per layer; this first version runs them as f32 FMAs
// on the CUDA cores and is far from either bound.
//
// Design: one block of 256 threads per (sequence, head) walks the tiles in
// order (the state makes them sequential; B * nh = 160 blocks at the
// card's shape).  A tile's x, B, C and a are staged in shared memory as
// f32, the state h stays in shared memory for the whole walk (rows padded
// by one float against bank conflicts; about 130 KB at hd = 64, N = 128,
// so the launch opts in above 48 KB).  Warp 0 takes the running sum of a
// with shuffles.  Thread (ty, tx) of a 16 x 16 grid computes a 4 x 4 patch
// of the masked scores, then rows ty + 16 i, columns tx + 16 j of y, then
// state entries (ty + 16 i, tx + 16 j).  Inputs are read through their
// strides, so B and C may be views broadcast over the heads (stride 0):
// the model passes its n_groups = 1 projections without repeating them.
// Any S is allowed; the tail tile is masked.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>

#include "float_io.cuh"

namespace {

using xlb::from_f32;
using xlb::to_f32;

constexpr int kThreads = 256;
constexpr int kT = 64;           // rows per tile

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
};

template <int HD, int N>
constexpr int smem_bytes() {
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

template <typename T, int HD, int N>
int launch(const SSDArgs& a, int B, cudaStream_t st) {
  constexpr int smem = smem_bytes<HD, N>();
  cudaError_t err = xlb::allow_smem(ssd_kernel<T, HD, N>, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<T, HD, N><<<B * a.nh, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_n(const SSDArgs& a, int B, int n, cudaStream_t st) {
  switch (n) {
    case 32: return launch<T, HD, 32>(a, B, st);
    case 64: return launch<T, HD, 64>(a, B, st);
    case 128: return launch<T, HD, 128>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_hd(const SSDArgs& a, int B, int hd, int n, cudaStream_t st) {
  switch (hd) {
    case 32: return launch_n<T, 32>(a, B, n, st);
    case 64: return launch_n<T, 64>(a, B, n, st);
    case 128: return launch_n<T, 128>(a, B, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int xlb_ssd_scan(
    const void* x, const float* a_log, const void* b, const void* c,
    void* y, float* h_last, int B, int S, int nh, int hd, int n, int dtype,
    long long xsb, long long xss, long long xsh, long long asb,
    long long ass, long long ash, long long bsb, long long bss,
    long long bsh, long long csb, long long css, long long csh,
    void* stream) {
  if (S <= 0) return (int)cudaErrorInvalidValue;
  SSDArgs a{x, b, c, a_log, y, h_last, S, nh, xsb, xss, xsh, asb, ass, ash,
            bsb, bss, bsh, csb, css, csh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == xlb::kF32) return launch_hd<float>(a, B, hd, n, st);
  if (dtype == xlb::kBF16) return launch_hd<__nv_bfloat16>(a, B, hd, n, st);
  return (int)cudaErrorInvalidValue;
}
