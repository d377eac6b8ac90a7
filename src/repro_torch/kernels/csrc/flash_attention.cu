// GQA prefill attention (causal or not) with an online softmax, for Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (behind
// ops.flash_attention); semantics pinned by
// src/repro/kernels/ref.py::flash_attention_ref: for query head h and KV
// head h / G, softmax over the keys (kpos <= qpos when causal; masked
// scores -1e30) of (q . k) * scale in f32, times v; the denominator is
// clamped at 1e-30.  The Pallas kernel skips a KV block when
// qi * block_q < ki * block_k, which also drops blocks that hold valid keys
// when block_q > block_k; this kernel computes the reference function and
// skips a KV tile only when its first key lies past the last query of the
// tile.
//
// What bounds it: operations.  Causal prefill at minitron-4b's shape does
// about 4 * B * H * hd * S^2 / 2 flops against a few hundred MB of q, k, v
// and output.  This first version does them as f32 FMAs on the CUDA cores
// (no tensor cores, no TMA, no pipelining), so it sits far below the bf16
// tensor-core bound; wgmma is later work.
//
// Design: a block of 256 threads owns kBQ = 64 queries of one (sequence,
// query head), walks the KV tiles of kBK = 64 keys in order and keeps the
// online-softmax state in registers.  Q, K and V tiles are staged in shared
// memory as f32 (rows padded by one float against bank conflicts; about
// 113 KB at hd = 128, so the launch opts in above 48 KB).  Thread (ty, tx)
// of a 16 x 16 grid computes the scores of rows ty + 16 i and keys
// tx + 16 j (4 x 4 in registers), reduces the row max and sum over the 16
// lanes of its half-warp with shuffles, writes the probabilities to shared
// memory, and accumulates rows ty + 16 i, columns tx + 16 j of P V.  The
// GQA mapping is in the address: no K/V is replicated.  Any S is allowed:
// keys past S are excluded and rows past S are not written.  With the
// causal mask the tiles with the most work are launched first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>

#include "float_io.cuh"

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
};

template <int HD>
constexpr int smem_bytes() {
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

  const T* qb = q + b * a.qsb + h * a.qsh;
  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
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
      for (int c = 0; c < kC; ++c)
        ob[(long long)r * a.oss + tx + 16 * c] = from_f32<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int HD>
int launch(const FlashArgs& a, int B, cudaStream_t st) {
  constexpr int smem = smem_bytes<HD>();
  cudaError_t err = xlb::allow_smem(flash_kernel<T, HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * a.H, (a.S + kBQ - 1) / kBQ);
  flash_kernel<T, HD><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const FlashArgs& a, int B, int hd, cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(a, B, st);
    case 64: return launch<T, 64>(a, B, st);
    case 128: return launch<T, 128>(a, B, st);
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
  FlashArgs a{q, k, v, out, S, H, K, H / K, causal, qsb, qss, qsh, ksb, kss,
              ksh, vsb, vss, vsh, osb, oss, osh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == xlb::kF32) return launch_hd<float>(a, B, hd, st);
  if (dtype == xlb::kBF16) return launch_hd<__nv_bfloat16>(a, B, hd, st);
  return (int)cudaErrorInvalidValue;
}
