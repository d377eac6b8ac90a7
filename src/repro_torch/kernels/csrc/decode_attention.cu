// One-token GQA decode attention against a KV cache, for Hopper.
//
// Replaces: src/repro/kernels/decode_attention.py::_decode_kernel (behind
// ops.decode_attention); semantics pinned by
// src/repro/kernels/ref.py::decode_attention_ref.  For sequence b and query
// head h = kh * G + g: softmax over the keys kpos <= lengths[b] of
// (q . k) * scale, in f32, then the weighted sum of v; the inclusive mask
// fills -1e30 and the denominator is clamped at 1e-30, as the Pallas
// kernel does.  A sequence with lengths[b] < 0 masks every key, and the
// softmax of an all -1e30 row is uniform: the kernel then reads every key
// with score -1e30, which gives the same mean of v.
//
// What bounds it: bytes.  Every valid key and value is read once and used
// for G multiply-adds per element (G = 3 for minitron-4b, 2 for the
// serving model): far below the card's 295 operations per byte.
//
// Design: the cache is read in place through its (B, S, K, hd) strides (no
// transpose copy, unlike the Pallas wrapper).  A block owns one
// (sequence, KV head) pair and one split of the key axis; the G query
// heads of the pair share each K/V tile of kTile = 32 keys staged in
// shared memory as f32.  Warp w scores query heads w, w + 4, ...: lane t
// takes key t of the tile, so the online-softmax max and sum are warp
// shuffles.  Each thread keeps a slice of the (G, hd) accumulator in
// registers.  Keys past min(lengths[b] + 1, S) are not read at all (their
// -1e30 scores contribute exactly zero in the reference).  With few
// (sequence, KV head) pairs (minitron decode: B * K = 16) the key axis is
// split over n_split blocks that write unnormalised partials (m, l, acc);
// a second kernel merges them.  With n_split == 1 (the serving model's
// 1024 x 2 pairs) the first kernel writes the output directly.  Any S is
// allowed; the tail tile is masked.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>

#include "float_io.cuh"

namespace {

using xlb::from_f32;
using xlb::to_f32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;        // keys per tile: one per lane
constexpr int kMaxG = 16;        // query heads per KV head
constexpr float kNegInf = -1e30f;

struct DecodeArgs {
  const void *q, *k, *v;
  const int* lengths;
  void* out;
  float *part_acc, *part_ml;
  int H, K, G, S;
  long long qsb, qsh;            // q (B, H, hd)
  long long ksb, kss, ksk;       // k cache (B, S, K, hd)
  long long vsb, vss, vsk;       // v cache
  int split_len, n_split;
  float scale;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD>
constexpr int smem_floats(int G) {
  return G * HD + kTile * (HD + 1) + kTile * HD + G * kTile + 3 * G;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeArgs a) {
  constexpr int kAcc = kMaxG * HD / kThreads;   // accumulator slice
  extern __shared__ float smem[];
  const int G = a.G;
  float* q_s = smem;                       // (G, HD)
  float* k_s = q_s + G * HD;               // (kTile, HD + 1)
  float* v_s = k_s + kTile * (HD + 1);     // (kTile, HD)
  float* p_s = v_s + kTile * HD;           // (G, kTile)
  float* m_s = p_s + G * kTile;            // (G,)
  float* l_s = m_s + G;                    // (G,)
  float* alpha_s = l_s + G;                // (G,)

  const T* q = static_cast<const T*>(a.q);
  const T* kc = static_cast<const T*>(a.k);
  const T* vc = static_cast<const T*>(a.v);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bk = blockIdx.x, b = bk / a.K, kh = bk % a.K;
  const int split = blockIdx.y;

  int n_valid = a.lengths[b] + 1 < a.S ? a.lengths[b] + 1 : a.S;
  const bool all_masked = n_valid <= 0;
  if (all_masked) n_valid = a.S;
  const int start = split * a.split_len;
  const int end = min(start + a.split_len, n_valid);

  for (int i = tid; i < G * HD; i += kThreads) {
    int g = i / HD, d = i % HD;
    q_s[i] = to_f32(q[b * a.qsb + (kh * G + g) * a.qsh + d]);
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
  const T* kbase = kc + b * a.ksb + kh * a.ksk;
  const T* vbase = vc + b * a.vsb + kh * a.vsk;
  __syncthreads();

  for (int t0 = start; t0 < end; t0 += kTile) {
    const int nt = min(kTile, end - t0);
    for (int i = tid; i < kTile * HD; i += kThreads) {
      int t = i / HD, d = i % HD;
      float kv = 0.f, vv = 0.f;
      if (t < nt) {
        long long s = t0 + t;
        kv = to_f32(kbase[s * a.kss + d]);
        vv = to_f32(vbase[s * a.vss + d]);
      }
      k_s[t * (HD + 1) + d] = kv;
      v_s[t * HD + d] = vv;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      const float m_old = m_s[g];
      float s = -INFINITY;                 // no key in this lane
      if (lane < nt) {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d)
          dot += q_s[g * HD + d] * k_s[lane * (HD + 1) + d];
        s = all_masked ? kNegInf : dot * a.scale;
      }
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = lane < nt ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      p_s[g * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int idx = tid + j * kThreads;
      if (idx < G * HD) {
        const int g = idx / HD, d = idx % HD;
        float o = acc[j] * alpha_s[g];
        for (int t = 0; t < nt; ++t) o += p_s[g * kTile + t] * v_s[t * HD + d];
        acc[j] = o;
      }
    }
    __syncthreads();
  }

  if (a.n_split == 1) {
    T* out = static_cast<T*>(a.out);
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int idx = tid + j * kThreads;
      if (idx < G * HD) {
        const int g = idx / HD, d = idx % HD;
        out[((long long)b * a.H + kh * G + g) * HD + d] =
            from_f32<T>(acc[j] / fmaxf(l_s[g], 1e-30f));
      }
    }
    return;
  }
  const long long part = (long long)bk * a.n_split + split;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int idx = tid + j * kThreads;
    if (idx < G * HD) a.part_acc[part * G * HD + idx] = acc[j];
  }
  for (int g = tid; g < G; g += kThreads) {
    a.part_ml[(part * G + g) * 2] = m_s[g];
    a.part_ml[(part * G + g) * 2 + 1] = l_s[g];
  }
}

// Merge the n_split partials of one (sequence, query head): one block of HD
// threads per (b, kh, g).
template <typename T, int HD>
__global__ void __launch_bounds__(HD) decode_merge_kernel(DecodeArgs a) {
  const int G = a.G;
  const int bkg = blockIdx.x, g = bkg % G, bk = bkg / G;
  const int b = bk / a.K, kh = bk % a.K, d = threadIdx.x;
  const float* ml = a.part_ml + ((long long)bk * a.n_split * G + g) * 2;
  float m = kNegInf;
  for (int i = 0; i < a.n_split; ++i) m = fmaxf(m, ml[i * G * 2]);
  float l = 0.f, o = 0.f;
  for (int i = 0; i < a.n_split; ++i) {
    const float w = expf(ml[i * G * 2] - m);
    l += ml[i * G * 2 + 1] * w;
    o += a.part_acc[(((long long)bk * a.n_split + i) * G + g) * HD + d] * w;
  }
  T* out = static_cast<T*>(a.out);
  out[((long long)b * a.H + kh * G + g) * HD + d] =
      from_f32<T>(o / fmaxf(l, 1e-30f));
}

template <typename T, int HD>
int launch(const DecodeArgs& a, int B, cudaStream_t st) {
  const int smem = sizeof(float) * smem_floats<HD>(a.G);
  cudaError_t err = xlb::allow_smem(decode_kernel<T, HD>, smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<T, HD><<<dim3(B * a.K, a.n_split), kThreads, smem, st>>>(a);
  if (a.n_split > 1)
    decode_merge_kernel<T, HD><<<B * a.K * a.G, HD, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const DecodeArgs& a, int B, int hd, cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(a, B, st);
    case 64: return launch<T, 64>(a, B, st);
    case 128: return launch<T, 128>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int xlb_decode_attention(
    const void* q, const void* k, const void* v, const int* lengths,
    void* out, float* part_acc, float* part_ml, int B, int H, int K, int S,
    int hd, int dtype, long long qsb, long long qsh, long long ksb,
    long long kss, long long ksk, long long vsb, long long vss,
    long long vsk, int split_len, int n_split, float scale, void* stream) {
  if (K <= 0 || H % K != 0 || H / K > kMaxG || n_split < 1 || split_len < 1)
    return (int)cudaErrorInvalidValue;
  DecodeArgs a{q, k, v, lengths, out, part_acc, part_ml, H, K, H / K, S,
               qsb, qsh, ksb, kss, ksk, vsb, vss, vsk, split_len, n_split,
               scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == xlb::kF32) return launch_hd<float>(a, B, hd, st);
  if (dtype == xlb::kBF16) return launch_hd<__nv_bfloat16>(a, B, hd, st);
  return (int)cudaErrorInvalidValue;
}
