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
// Design: everything serves keeping enough bytes in flight.  The cache is
// read in place through its (B, S, K, hd) strides, in 16-byte vector loads
// of its own type (8 bf16 or 4 f32 a lane): a group of LG = hd * size / 16
// lanes reads one key row, so one warp load covers R = 32 / LG whole rows.
// A block of 4 warps owns one (sequence, KV head) pair and one split of
// the key axis; its 4 R lane groups walk interleaved key streams, each
// with kUnroll rows of K and V in flight a lane, and no block barrier
// until the end.  A lane group keeps q, the online-softmax state (m, l)
// and its slice of the (G, hd) accumulator in registers for up to GP
// query heads, so one K row serves all of them; the dot products are
// reduced by shuffles inside the group.  With G > GP the heads are walked
// in passes of GP over the keys (no spills).  Up to GP = 3 the registers
// are capped so that 4 blocks fit on an SM.  At the end the lane groups
// of a warp merge their (m, l, acc) by shuffles and the 4 warps through
// shared memory.  Keys past min(lengths[b] + 1, S) are not read at all
// (their -1e30 scores contribute exactly zero in the reference).  With
// few (sequence, KV head) pairs (minitron decode: B * K = 16) the key axis
// is split into n_split blocks of split_len keys that write unnormalised
// partials (m, l, acc); a second kernel merges them.  With n_split == 1
// (the serving model's 1024 x 2 pairs) the first kernel writes the output
// directly; a cache of at most kSoloKeys keys (the serving model's 32) is
// walked by one warp per pair, so the block needs no merge and no barrier.
// Any S is allowed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>

#include "bounds.cuh"
#include "float_io.cuh"

namespace {

using xlb::from_f32;
using xlb::to_f32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;       // key rows in flight per lane group
constexpr int kSoloKeys = 128;   // caches this short: a warp per pair
constexpr float kNegInf = -1e30f;

struct DecodeArgs {
  const void *q, *k, *v;
  const int* lengths;
  void* out;
  float *part_acc, *part_ml;
  int pairs, H, K, G, S;          // pairs: B * K
  long long qsb, qsh;            // q (B, H, hd)
  long long ksb, kss, ksk;       // k cache (B, S, K, hd)
  long long vsb, vss, vsk;       // v cache
  int split_len, n_split;
  float scale;
#ifdef XLB_BOUNDS_CHECK
  long long nq, nk, nv, nout, npart;   // extents in elements
  int B;
#endif
};

// 16 bytes of the cache's type, widened to f32.
__device__ __forceinline__ void widen(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void widen(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// kSolo: each warp owns a whole (sequence, KV head) pair (short caches,
// n_split == 1), so nothing is merged across warps.
template <typename T, int HD, int GP, bool kSolo>
__global__ void __launch_bounds__(kThreads, GP <= 3 ? 4 : 2)
    decode_kernel(DecodeArgs a) {
  constexpr int VEC = 16 / (int)sizeof(T);   // elements per 16-byte load
  constexpr int LG = HD / VEC;               // lanes per key row
  constexpr int R = 32 / LG;                 // key rows per warp load
  constexpr int NG = kSolo ? R : kWarps * R; // key streams per pair
  __shared__ float acc_s[kWarps][GP][HD];
  __shared__ float m_s[kWarps][GP], l_s[kWarps][GP];

  const T* q = static_cast<const T*>(a.q);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane % LG, stream = (kSolo ? 0 : warp * R) + lane / LG;
  const int bk = kSolo ? blockIdx.x * kWarps + warp : blockIdx.x;
  if (kSolo && bk >= a.pairs) return;
  const int b = bk / a.K, kh = bk % a.K;
  const int split = blockIdx.y, G = a.G;

  XLB_CHECK(b, a.B);
  int n_valid = a.lengths[b] + 1 < a.S ? a.lengths[b] + 1 : a.S;
  const bool all_masked = n_valid <= 0;
  if (all_masked) n_valid = a.S;
  const int start = split * a.split_len;
  const int end = min(start + a.split_len, n_valid);
  const uint4* kbase = reinterpret_cast<const uint4*>(
      static_cast<const T*>(a.k) + b * a.ksb + kh * a.ksk + sub * VEC);
  const uint4* vbase = reinterpret_cast<const uint4*>(
      static_cast<const T*>(a.v) + b * a.vsb + kh * a.vsk + sub * VEC);
  const long long kstep = a.kss * (long long)sizeof(T) / 16;   // in uint4
  const long long vstep = a.vss * (long long)sizeof(T) / 16;

  for (int g0 = 0; g0 < G; g0 += GP) {
    const int gn = min(GP, G - g0);
    float qv[GP][VEC], acc[GP][VEC], m[GP], l[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const long long qo = b * a.qsb + (kh * G + g0 + g) * a.qsh + sub * VEC;
      const T* qh = q + qo;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (g < gn) XLB_CHECK(qo + e, a.nq);
        qv[g][e] = g < gn ? to_f32(qh[e]) : 0.f;
        acc[g][e] = 0.f;
      }
      m[g] = kNegInf;
      l[g] = 0.f;
    }

    for (int base = start; base < end; base += kUnroll * NG) {
      uint4 kr[kUnroll], vr[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int key = base + u * NG + stream;
        ok[u] = key < end;
        if (ok[u]) {
          XLB_CHECK(b * a.ksb + kh * a.ksk + sub * VEC + key * a.kss + VEC - 1,
                    a.nk);
          XLB_CHECK(b * a.vsb + kh * a.vsk + sub * VEC + key * a.vss + VEC - 1,
                    a.nv);
        }
        kr[u] = ok[u] ? __ldg(kbase + key * kstep) : make_uint4(0, 0, 0, 0);
        vr[u] = ok[u] ? __ldg(vbase + key * vstep) : make_uint4(0, 0, 0, 0);
      }
      float s[GP][kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kf[VEC];
        widen(kr[u], kf);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d += qv[g][e] * kf[e];
#pragma unroll
          for (int o = 1; o < LG; o <<= 1)
            d += __shfl_xor_sync(0xffffffffu, d, o);
          s[g][u] = !ok[u] ? -INFINITY : all_masked ? kNegInf : d * a.scale;
        }
      }
      float alpha[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, s[g][u]);
        alpha[g] = expf(m[g] - mx);
        m[g] = mx;
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          s[g][u] = expf(s[g][u] - mx);        // -inf (no key) gives 0
          sum += s[g][u];
        }
        l[g] = l[g] * alpha[g] + sum;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha[g];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float vf[VEC];
        widen(vr[u], vf);
#pragma unroll
        for (int g = 0; g < GP; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] += s[g][u] * vf[e];
      }
    }

    // merge the R lane groups of the warp, then the warps
#pragma unroll
    for (int o = LG; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float mx = fmaxf(m[g], mo);
        const float w = expf(m[g] - mx), wo = expf(mo - mx);
        l[g] = l[g] * w + lo * wo;
        m[g] = mx;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[g][e] = acc[g][e] * w +
                      __shfl_xor_sync(0xffffffffu, acc[g][e], o) * wo;
      }
    }
    if constexpr (kSolo) {
      T* out = static_cast<T*>(a.out) +
               ((long long)b * a.H + kh * G + g0) * HD + sub * VEC;
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (lane < LG && g < gn) {
            XLB_CHECK(((long long)b * a.H + kh * G + g0 + g) * HD + sub * VEC +
                          e, a.nout);
            out[g * HD + e] = from_f32<T>(acc[g][e] / fmaxf(l[g], 1e-30f));
          }
      continue;
    }
    if (lane < LG) {
#pragma unroll
      for (int g = 0; g < GP; ++g) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc_s[warp][g][sub * VEC + e] = acc[g][e];
        if (lane == 0) {
          m_s[warp][g] = m[g];
          l_s[warp][g] = l[g];
        }
      }
    }
    __syncthreads();
    const long long part = (long long)bk * a.n_split + split;
    for (int i = tid; i < gn * HD; i += kThreads) {
      const int g = i / HD, d = i % HD;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
      float lsum = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = expf(m_s[w][g] - mx);
        lsum += l_s[w][g] * wt;
        o += acc_s[w][g][d] * wt;
      }
      if (a.n_split == 1) {
        static_cast<T*>(a.out)[XLB_IX(
            ((long long)b * a.H + kh * G + g0 + g) * HD + d, a.nout)] =
            from_f32<T>(o / fmaxf(lsum, 1e-30f));
      } else {
        XLB_CHECK((part * G + g0 + g) * HD + d, a.npart * HD);
        XLB_CHECK((part * G + g0 + g) * 2 + 1, a.npart * 2);
        a.part_acc[(part * G + g0 + g) * HD + d] = o;
        if (d == 0) {
          a.part_ml[(part * G + g0 + g) * 2] = mx;
          a.part_ml[(part * G + g0 + g) * 2 + 1] = lsum;
        }
      }
    }
    __syncthreads();                       // before the next pass
  }
}

// Merge the n_split partials of one (sequence, query head): a block of
// kMergeWarps warps per (b, kh, g); warp w folds splits w, w + kMergeWarps,
// ... (a lane holds hd / 32 dims; at hd 16 lanes 0-15 hold one each), then
// the warps merge through shared memory.
constexpr int kMergeWarps = 16;

template <typename T, int HD>
__global__ void __launch_bounds__(kMergeWarps * 32)
    decode_merge_kernel(DecodeArgs a) {
  constexpr int V = HD >= 32 ? HD / 32 : 1;   // dims a lane holds
  __shared__ float acc_s[kMergeWarps][HD];
  __shared__ float m_s[kMergeWarps], l_s[kMergeWarps];
  const int G = a.G;
  const int bkg = blockIdx.x, g = bkg % G, bk = bkg / G;
  const int b = bk / a.K, kh = bk % a.K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool mine = lane * V < HD;
  float m = kNegInf, l = 0.f, acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  for (int i = warp; i < a.n_split; i += kMergeWarps) {
    const long long part = ((long long)bk * a.n_split + i) * G + g;
    XLB_CHECK(part, a.npart);
    const float mi = a.part_ml[part * 2], li = a.part_ml[part * 2 + 1];
    const float* pa = a.part_acc + part * HD + lane * V;
    const float mx = fmaxf(m, mi), w = expf(m - mx), wi = expf(mi - mx);
    l = l * w + li * wi;
#pragma unroll
    for (int e = 0; e < V; ++e)
      acc[e] = acc[e] * w + (mine ? pa[e] : 0.f) * wi;
    m = mx;
  }
  if (mine) {
#pragma unroll
    for (int e = 0; e < V; ++e) acc_s[warp][lane * V + e] = acc[e];
  }
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < HD; d += kMergeWarps * 32) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kMergeWarps; ++w) mx = fmaxf(mx, m_s[w]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kMergeWarps; ++w) {
      const float wt = expf(m_s[w] - mx);
      lsum += l_s[w] * wt;
      o += acc_s[w][d] * wt;
    }
    static_cast<T*>(a.out)[XLB_IX(((long long)b * a.H + kh * G + g) * HD + d,
                                  a.nout)] =
        from_f32<T>(o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int HD, int GP>
int launch(const DecodeArgs& a, cudaStream_t st) {
  if (a.n_split == 1 && a.S <= kSoloKeys) {
    decode_kernel<T, HD, GP, true>
        <<<(a.pairs + kWarps - 1) / kWarps, kThreads, 0, st>>>(a);
  } else {
    decode_kernel<T, HD, GP, false>
        <<<dim3(a.pairs, a.n_split), kThreads, 0, st>>>(a);
    if (a.n_split > 1)
      decode_merge_kernel<T, HD>
          <<<a.pairs * a.G, kMergeWarps * 32, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// Query heads per pass: all of G up to 4; beyond, f32 walks passes of 8
// (4 values a lane per head), bf16 passes of 4 (8 values a lane per head),
// for any G.
template <typename T, int HD>
int launch_g(const DecodeArgs& a, cudaStream_t st) {
  switch (a.G) {
    case 1: return launch<T, HD, 1>(a, st);
    case 2: return launch<T, HD, 2>(a, st);
    case 3: return launch<T, HD, 3>(a, st);
    case 4: return launch<T, HD, 4>(a, st);
    default: return sizeof(T) == 2 ? launch<T, HD, 4>(a, st)
                                   : launch<T, HD, 8>(a, st);
  }
}

template <typename T>
int launch_hd(const DecodeArgs& a, int hd, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_g<T, 16>(a, st);
    case 32: return launch_g<T, 32>(a, st);
    case 64: return launch_g<T, 64>(a, st);
    case 128: return launch_g<T, 128>(a, st);
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
  if (K <= 0 || H % K != 0 || n_split < 1 || split_len < 1)
    return (int)cudaErrorInvalidValue;
  DecodeArgs a{q,   k,   v,   lengths, out, part_acc, part_ml, B * K,
               H,   K,   H / K, S, qsb, qsh, ksb, kss, ksk, vsb, vss, vsk,
               split_len, n_split, scale};
#ifdef XLB_BOUNDS_CHECK
  // the last element of each strided view, plus one
  a.nq = (B - 1) * qsb + (H - 1) * qsh + hd;
  a.nk = (B - 1) * ksb + (S - 1) * kss + (K - 1) * ksk + hd;
  a.nv = (B - 1) * vsb + (S - 1) * vss + (K - 1) * vsk + hd;
  a.nout = (long long)B * H * hd;
  a.npart = n_split > 1 ? (long long)B * K * n_split * (H / K) : 0;
  a.B = B;
#endif
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == xlb::kF32) return launch_hd<float>(a, hd, st);
  if (dtype == xlb::kBF16) return launch_hd<__nv_bfloat16>(a, hd, st);
  return (int)cudaErrorInvalidValue;
}
