// Connection completion (the close path of one serving tick) for Hopper.
//
// Replaces: src/repro/kernels/completion.py::_complete_kernel (the Pallas
// kernel behind ops.complete), semantics pinned by
// src/repro/kernels/ref.py::complete_ref.
//
// What bounds it: latency.  Per (instance, slot) cell it reads six int32
// and one bool and writes five int32 and two bools; the (E,) / (S,) tables
// are a few KB.  At the serving shape (64 x 16 = 1024 cells) that is
// ~70 KB, about 20 ns of HBM time, far below one launch: what is left
// above the launch is DRAM round trips, barriers and atomics in series.
//
// Design: ONE block of kThreads threads (the admission kernel already
// holds the whole I x C pool in one block, so a pool never outgrows this).
// - One DRAM round trip: at entry each thread loads the (E,) / (S,) table
//   entries it owns into registers and its first kCells consecutive cells
//   (8-byte loads of the int32 fields, 2 bytes of each bool field, where
//   every pointer allows; scalar loads with a ragged tail otherwise); the
//   shared histograms (E + S ints) are zeroed while those loads fly.
// - Each cell writes the six pool fields and `done`, and folds its release
//   and its rx count into the histograms with one shared atomic each.
//   Integer sums commute: bit-exact in any order.  (Warp-aggregated folds,
//   __match_any_sync and one add per group, measured slower at every
//   contention tried, a whole pool on one endpoint included: the shared
//   atomic unit resolves a warp's same-address adds faster than a match.)
// - One barrier, then the epilogue from the registers: ep_load - released,
//   rx + 2 * counted, done_cnt and the two f32 EWMAs, written with
//   __fsub_rn / __fmul_rn / __fadd_rn so nvcc cannot contract them into an
//   FMA (the reference rounds every step).
// 512 threads of two cells measured faster than 256 of four (16-byte
// loads) or 1024 of one at the serving shape.

#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kCells = 2;        // consecutive cells per thread and step
constexpr int kOwn = 1;          // (E,) entries a thread loads at entry
constexpr int kRxBytesPerToken = 2;
constexpr int kSmemDefault = 48 * 1024;

// kCells int32 from p + i0: one 8-byte load when `vec`, else scalar
// loads of the cells below n (0 past it).
__device__ __forceinline__ void load2(int (&x)[kCells], const int* p, int i0,
                                      int n, bool vec) {
  if (vec) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p + i0));
    x[0] = v.x;
    x[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < kCells; ++j) x[j] = i0 + j < n ? p[i0 + j] : 0;
  }
}

__device__ __forceinline__ void load2(bool (&x)[kCells], const bool* p,
                                      int i0, int n, bool vec) {
  if (vec) {
    const unsigned short v =
        __ldg(reinterpret_cast<const unsigned short*>(p + i0));
    x[0] = v & 0xFF;
    x[1] = v >> 8;
  } else {
#pragma unroll
    for (int j = 0; j < kCells; ++j) x[j] = i0 + j < n && p[i0 + j];
  }
}

__device__ __forceinline__ void store2(int* p, const int (&x)[kCells], int i0,
                                       int n, bool vec) {
  if (vec) {
    *reinterpret_cast<int2*>(p + i0) = make_int2(x[0], x[1]);
  } else {
#pragma unroll
    for (int j = 0; j < kCells; ++j)
      if (i0 + j < n) p[i0 + j] = x[j];
  }
}

__device__ __forceinline__ void store2(bool* p, const bool (&x)[kCells],
                                       int i0, int n, bool vec) {
  if (vec) {
    *reinterpret_cast<unsigned short*>(p + i0) =
        (unsigned short)(x[0] | x[1] << 8);
  } else {
#pragma unroll
    for (int j = 0; j < kCells; ++j)
      if (i0 + j < n) p[i0 + j] = x[j];
  }
}

struct Cells {                   // kCells consecutive cells of the pool
  int req[kCells], ep[kCells], sv[kCells], len[kCells], tok[kCells],
      nx[kCells];
  bool act[kCells];
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads) complete_kernel(
    const int* __restrict__ preq, const int* __restrict__ pep,
    const int* __restrict__ psvc, const int* __restrict__ plen,
    const int* __restrict__ ptok, const bool* __restrict__ pact,
    const int* __restrict__ nxt, const int* __restrict__ load0,
    const int* __restrict__ rx0, const float* __restrict__ ewl0,
    const float* __restrict__ ewt0,
    int* __restrict__ oreq, int* __restrict__ oep, int* __restrict__ osvc,
    int* __restrict__ olen, int* __restrict__ otok, bool* __restrict__ oact,
    bool* __restrict__ odone, int* __restrict__ load_out,
    int* __restrict__ rx_out, int* __restrict__ done_cnt,
    float* __restrict__ ewl, float* __restrict__ ewt, int n, int E, int S,
    int eos, int max_len, float alpha_inflight, float alpha_tput) {
  extern __shared__ int smem[];
  int* dec = smem;          // (E,) releases
  int* rx = smem + E;       // (S,) active slots per service
  const int tid = threadIdx.x;

  // the table entries this thread owns, in flight with the cells
  int l0[kOwn];
  float a0[kOwn], b0[kOwn];
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    const int k = tid + j * kThreads;
    l0[j] = k < E ? load0[k] : 0;
    a0[j] = k < E ? ewl0[k] : 0.f;
    b0[j] = k < E ? ewt0[k] : 0.f;
  }
  const int r0 = tid < S ? rx0[tid] : 0;

  const int units = (n + kCells - 1) / kCells;
  Cells c;
  auto load_unit = [&](int v) {
    const int i0 = v * kCells;
    const bool vec = kVec && i0 + kCells <= n;
    load2(c.req, preq, i0, n, vec);
    load2(c.ep, pep, i0, n, vec);
    load2(c.sv, psvc, i0, n, vec);
    load2(c.len, plen, i0, n, vec);
    load2(c.tok, ptok, i0, n, vec);
    load2(c.nx, nxt, i0, n, vec);
    load2(c.act, pact, i0, n, vec);   // false past n: no fold
  };
  load_unit(tid);
  for (int k = tid; k < E + S; k += kThreads) smem[k] = 0;
  __syncthreads();

  for (int v = tid; v < units; v += kThreads) {
    if (v != tid) load_unit(v);
    const int i0 = v * kCells;
    const bool vec = kVec && i0 + kCells <= n;
    int req[kCells], ep[kCells], len[kCells], tok[kCells];
    bool act[kCells], done[kCells];
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      const bool a = c.act[j];
      const int new_len = a ? c.len[j] + 1 : c.len[j];
      const bool d = a && (c.nx[j] == eos || new_len >= max_len - 1);
      req[j] = d ? -1 : c.req[j];
      ep[j] = d ? -1 : c.ep[j];
      len[j] = d ? 0 : new_len;
      tok[j] = a ? c.nx[j] : c.tok[j];
      act[j] = a && !d;
      done[j] = d;
      if (d && c.ep[j] >= 0 && c.ep[j] < E) atomicAdd(&dec[c.ep[j]], 1);
      const int svc = c.sv[j] < 0 ? 0 : c.sv[j];
      if (a && svc < S) atomicAdd(&rx[svc], 1);     // svc >= S drops
    }
    store2(oreq, req, i0, n, vec);
    store2(oep, ep, i0, n, vec);
    store2(osvc, c.sv, i0, n, vec);
    store2(olen, len, i0, n, vec);
    store2(otok, tok, i0, n, vec);
    store2(oact, act, i0, n, vec);
    store2(odone, done, i0, n, vec);
  }
  __syncthreads();

  auto finish = [&](int k, int l, float a, float b) {
    const int d = dec[k];
    load_out[k] = l - d;
    done_cnt[k] = d;
    const float occ = __int2float_rn(l);
    const float cnt = __int2float_rn(d);
    ewl[k] = __fadd_rn(a, __fmul_rn(alpha_inflight, __fsub_rn(occ, a)));
    ewt[k] = __fadd_rn(b, __fmul_rn(alpha_tput, __fsub_rn(cnt, b)));
  };
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    const int k = tid + j * kThreads;
    if (k < E) finish(k, l0[j], a0[j], b0[j]);
  }
  for (int k = tid + kOwn * kThreads; k < E; k += kThreads)
    finish(k, load0[k], ewl0[k], ewt0[k]);
  if (tid < S) rx_out[tid] = r0 + kRxBytesPerToken * rx[tid];
  for (int k = tid + kThreads; k < S; k += kThreads)
    rx_out[k] = rx0[k] + kRxBytesPerToken * rx[k];
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// Launches the vector build when every (I, C) pointer allows it (int32
// fields on 8 bytes, bool fields on 2), the scalar build otherwise.
extern "C" int xlb_complete(
    const int* preq, const int* pep, const int* psvc, const int* plen,
    const int* ptok, const bool* pact, const int* nxt,
    const int* load0, const int* rx0, const float* ewl0, const float* ewt0,
    int* oreq, int* oep, int* osvc, int* olen, int* otok, bool* oact,
    bool* odone, int* load_out, int* rx_out, int* done_cnt,
    float* ewl, float* ewt, int n, int E, int S, int eos, int max_len,
    float alpha_inflight, float alpha_tput, void* stream) {
  const size_t smem = sizeof(int) * ((size_t)E + S);
  if (n < 0 || E < 0 || S < 0 || smem > kSmemDefault)
    return (int)cudaErrorInvalidValue;
  bool vec = aligned(pact, 2) && aligned(oact, 2) && aligned(odone, 2);
  for (const void* p : {(const void*)preq, (const void*)pep,
                        (const void*)psvc, (const void*)plen,
                        (const void*)ptok, (const void*)nxt, (const void*)oreq,
                        (const void*)oep, (const void*)osvc,
                        (const void*)olen, (const void*)otok})
    vec = vec && aligned(p, 8);
  auto kernel = vec ? complete_kernel<true> : complete_kernel<false>;
  kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      preq, pep, psvc, plen, ptok, pact, nxt, load0, rx0, ewl0, ewt0, oreq,
      oep, osvc, olen, otok, oact, odone, load_out, rx_out, done_cnt, ewl,
      ewt, n, E, S, eos, max_len, alpha_inflight, alpha_tput);
  return (int)cudaGetLastError();
}
