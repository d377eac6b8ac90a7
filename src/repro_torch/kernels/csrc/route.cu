// Stateless route match for Hopper: first-match rule walk plus the
// least-request argmin over the matched cluster's endpoint window.
//
// Replaces: src/repro/kernels/route_match.py::_route_kernel (behind
// ops.route_match); semantics pinned by src/repro/kernels/ref.py::
// route_match_ref (core/router.py::match_cluster + a window argmin).
//
// Contract, per request r:
//   svc is clamped to [0, S-1]; cluster = the first matching rule's
//   cluster, -1 when none matches (match.cuh, shared with admit.cu);
//   cl = cluster clamped to [0, CL-1] (the Pallas kernel clamps only from
//   below; build_state never emits a cluster >= CL, and the clamp keeps a
//   corrupt table inside the cluster arrays);
//   endpoint = the FIRST minimum over the 64-lane window of
//   ep_load[clip(start + j, 0, E-1)], lanes j >= count at BIG = 2**30,
//   and -1 where cluster < 0 or count == 0.  No drain mask: this building
//   block is the load-only scan (the admission kernel applies drains).
//
// What bounds it: launch latency.  Each request reads its svc and F
// features, walks at most 16 rules of small tables and scans 64 loads of
// a 2 KB table that stays in L1/L2: a few KB per 256 requests and a few
// hundred integer operations each, far under one launch of this card.
//
// Design: nothing is carried between requests, so - unlike the TPU's
// sequential grid - every request is independent: ceil(R / 256) blocks of
// 256 threads, one thread per request, no shared memory, no atomics.

#include <cuda_runtime.h>

#include "match.cuh"

namespace {

using xlb::clampi;

constexpr int kBlock = 256;
constexpr int kWE = 64;          // MAX_EPS_PER_CLUSTER
constexpr int kBig = 1 << 30;    // load of a lane outside the window

__global__ void __launch_bounds__(kBlock)
route_kernel(const int* __restrict__ svc, const int* __restrict__ feats,
             int R, int F, const int* __restrict__ rs,
             const int* __restrict__ rc, const int* __restrict__ rf,
             const int* __restrict__ rv, const int* __restrict__ rcl, int S,
             int NR, const int* __restrict__ cs, const int* __restrict__ cc,
             int CL, const int* __restrict__ load, int E,
             int* __restrict__ cluster_out, int* __restrict__ ep_out) {
  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r >= R) return;
  const int s = clampi(svc[r], 0, S - 1);
  const int cluster = xlb::match_rule(feats + (long long)r * F, F, s, rs,
                                      rc, rf, rv, rcl, NR);
  const int cl = clampi(cluster, 0, CL - 1);
  const int estart = cs[cl], count = cc[cl];
  int best = 0, best_j = 0;
  for (int j = 0; j < kWE; ++j) {
    const int v = j < count ? load[clampi(estart + j, 0, E - 1)] : kBig;
    if (j == 0 || v < best) {    // strict: the first minimum wins
      best = v;
      best_j = j;
    }
  }
  cluster_out[r] = cluster;
  ep_out[r] = (cluster >= 0 && count > 0)
                  ? clampi(estart + best_j, 0, E - 1)
                  : -1;
}

}  // namespace

extern "C" int xlb_route(const int* svc, const int* feats, int R, int F,
                         const int* rs, const int* rc, const int* rf,
                         const int* rv, const int* rcl, int S, int NR,
                         const int* cs, const int* cc, int CL,
                         const int* load, int E, int* cluster, int* ep,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (R + kBlock - 1) / kBlock;
  route_kernel<<<blocks, kBlock, 0, st>>>(svc, feats, R, F, rs, rc, rf, rv,
                                          rcl, S, NR, cs, cc, CL, load, E,
                                          cluster, ep);
  return (int)cudaGetLastError();
}
