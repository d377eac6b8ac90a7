// Connection completion (the close path of one serving tick) for Hopper.
//
// Replaces: src/repro/kernels/completion.py::_complete_kernel (the Pallas
// kernel behind ops.complete), semantics pinned by
// src/repro/kernels/ref.py::complete_ref.
//
// What bounds it: launch latency.  Per (instance, slot) cell it reads six
// int32 and one bool and writes five int32 and two bools; the (E,) / (S,)
// tables are a few KB.  At the serving shape (64 x 16 = 1024 cells) that
// is ~70 KB, about 20 ns of HBM time, far below one launch.
//
// Design: ONE thread block of kThreads threads loops over the cells (the
// admission kernel already holds the whole I x C pool in one block, so a
// pool never outgrows this).  Each cell writes the six pool fields and
// `done`, and folds its release and its rx count into shared-memory
// histograms (E + S ints) with integer atomics, which commute, so the
// result is bit-exact whatever the order.  After one barrier the same
// block writes ep_load - released, rx + 2 * counted, done_cnt and the two
// f32 EWMAs: no global accumulators, no zeroed scratch, one launch.  The
// EWMAs are written with __fsub_rn / __fmul_rn / __fadd_rn so nvcc cannot
// contract them into an FMA (the reference rounds every step).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kRxBytesPerToken = 2;

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
  for (int k = threadIdx.x; k < E + S; k += kThreads) smem[k] = 0;
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += kThreads) {
    bool act = pact[i];
    int len = plen[i];
    int new_len = act ? len + 1 : len;
    int tok = nxt[i];
    bool done = act && (tok == eos || new_len >= max_len - 1);
    int ep = pep[i];
    int sv = psvc[i];
    oreq[i] = done ? -1 : preq[i];
    oep[i] = done ? -1 : ep;
    osvc[i] = sv;
    olen[i] = done ? 0 : new_len;
    otok[i] = act ? tok : ptok[i];
    oact[i] = act && !done;
    odone[i] = done;
    if (done && ep >= 0 && ep < E) atomicAdd(&dec[ep], 1);
    int svc = sv < 0 ? 0 : sv;
    if (act && svc < S) atomicAdd(&rx[svc], 1);   // svc >= S drops
  }
  __syncthreads();

  for (int k = threadIdx.x; k < E; k += kThreads) {
    int l0 = load0[k];
    int d = dec[k];
    load_out[k] = l0 - d;
    done_cnt[k] = d;
    float occ = __int2float_rn(l0);
    float cnt = __int2float_rn(d);
    float a = ewl0[k], b = ewt0[k];
    ewl[k] = __fadd_rn(a, __fmul_rn(alpha_inflight, __fsub_rn(occ, a)));
    ewt[k] = __fadd_rn(b, __fmul_rn(alpha_tput, __fsub_rn(cnt, b)));
  }
  for (int k = threadIdx.x; k < S; k += kThreads)
    rx_out[k] = rx0[k] + kRxBytesPerToken * rx[k];
}

}  // namespace

// Shared memory one launch needs for E endpoints and S services.
extern "C" int xlb_complete_smem_bytes(int E, int S) {
  return (int)sizeof(int) * (E + S);
}

extern "C" int xlb_complete(
    const int* preq, const int* pep, const int* psvc, const int* plen,
    const int* ptok, const bool* pact, const int* nxt,
    const int* load0, const int* rx0, const float* ewl0, const float* ewt0,
    int* oreq, int* oep, int* osvc, int* olen, int* otok, bool* oact,
    bool* odone, int* load_out, int* rx_out, int* done_cnt,
    float* ewl, float* ewt, int n, int E, int S, int eos, int max_len,
    float alpha_inflight, float alpha_tput, void* stream) {
  complete_kernel<<<1, kThreads, xlb_complete_smem_bytes(E, S),
                    static_cast<cudaStream_t>(stream)>>>(
      preq, pep, psvc, plen, ptok, pact, nxt, load0, rx0, ewl0, ewt0, oreq,
      oep, osvc, olen, otok, oact, odone, load_out, rx_out, done_cnt, ewl,
      ewt, n, E, S, eos, max_len, alpha_inflight, alpha_tput);
  return (int)cudaGetLastError();
}
