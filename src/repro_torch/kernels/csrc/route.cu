// Stateless route match for Hopper: first-match rule walk plus the
// least-request argmin over the matched cluster's endpoint window.
//
// Replaces: src/repro/kernels/route_match.py::_route_kernel (behind
// ops.route_match); semantics pinned by src/repro/kernels/ref.py::
// route_match_ref (core/router.py::match_cluster + a window argmin).
//
// Contract, per request r:
//   svc is clamped to [0, S-1]; cluster = the first matching rule's
//   cluster, -1 when none matches (the rule walk of match.cuh: a feature
//   column wraps once when negative and reads INT_MIN when still outside
//   [0, F); the wildcard matches anything);
//   cl = cluster clamped to [0, CL-1] (the Pallas kernel clamps only from
//   below; build_state never emits a cluster >= CL, and the clamp keeps a
//   corrupt table inside the cluster arrays);
//   endpoint = the FIRST minimum over the 64-lane window of
//   ep_load[clip(start + j, 0, E-1)], lanes j >= count at BIG = 2**30,
//   and -1 where cluster < 0 or count == 0.  No drain mask: this building
//   block is the load-only scan (the admission kernel applies drains).
//
// What bounds it: latency.  A request reads its svc and F features, then
// a chain of dependent reads of small tables (svc -> rule window -> rules
// -> cluster window -> loads): a few KB per 256 requests and a few hundred
// integer operations each, far under one launch of this card.
//
// Design: one warp per request, kWarps requests per block, so R = 256
// spreads over 32 SMs.  Every load that depends on no other is issued in
// the prologue: the request's svc, its F feature words (lane f holds
// feature f) and, where S and CL are at most 64 (the paper's capacities),
// the whole rule-window table (rs, rc) and cluster-window table (cs, cc),
// two words of each per lane, so that the service's and the cluster's
// window are shuffles, not reads.  What is left of the chain is two round
// trips: the rules, then the loads.  The rules are walked in parallel:
// lane t checks rule start + t, takes its feature from lane col by a
// shuffle, and a ballot's first set bit is the first match.  The argmin
// is a warp reduction: each lane holds lanes j and j + 32 of the window,
// __reduce_min_sync finds the least load (signed, as the plain version
// compares), and two ballots find the smallest lane holding it.
//
// The tables are read through L1/L2, not staged in shared memory: one
// coalesced staging pass of all eight (~6 KB) per block measured slower
// on an H100 at R = 256 and 4096 (PERF.md §6).

#include <climits>
#include <cuda_runtime.h>

#include "match.cuh"

namespace {

using xlb::clampi;

constexpr int kWarps = 8;         // requests (one warp each) per block
constexpr int kBlock = 32 * kWarps;
constexpr int kWE = 64;           // MAX_EPS_PER_CLUSTER
constexpr int kBig = 1 << 30;     // load of a lane outside the window
constexpr int kHeld = 64;         // table rows a warp holds, two a lane
constexpr unsigned kFull = 0xffffffffu;

static_assert(kWE == 64, "the argmin holds two window lanes per lane");
static_assert(xlb::kRules <= 32, "one rule per lane");

struct Tables {
  const int* rs;     // (S,) rule window start per service
  const int* rc;     // (S,) rule window count per service
  const int* rf;     // (NR,) feature column per rule
  const int* rv;     // (NR,) expected value per rule
  const int* rcl;    // (NR,) destination cluster per rule
  const int* cs;     // (CL,) endpoint window start per cluster
  const int* cc;     // (CL,) endpoint window count per cluster
  const int* load;   // (E,) outstanding requests per endpoint
  int S, NR, CL, E;
};

// Rows lane and lane + 32 of a table of n <= kHeld rows.
struct Held {
  int lo, hi;
};

__device__ __forceinline__ Held hold(const int* t, int n, int lane) {
  return {lane < n ? t[lane] : 0, lane + 32 < n ? t[lane + 32] : 0};
}

// Row i (< kHeld) of a held table, for every lane of the warp.
__device__ __forceinline__ int row_of(Held h, int i) {
  const int lo = __shfl_sync(kFull, h.lo, i & 31);
  const int hi = __shfl_sync(kFull, h.hi, i & 31);
  return i < 32 ? lo : hi;
}

__global__ void __launch_bounds__(kBlock)
route_kernel(const int* __restrict__ svc, const int* __restrict__ feats,
             int R, int F, Tables t, int* __restrict__ cluster_out,
             int* __restrict__ ep_out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;                            // uniform over the warp
  const int* row = feats + (long long)r * F;
  // prologue: every load that depends on no other
  const int s_raw = svc[r];
  const int fw = lane < F ? row[lane] : INT_MIN;
  const bool held_s = t.S <= kHeld, held_cl = t.CL <= kHeld;
  Held rs{}, rc{}, cs{}, cc{};
  if (held_s) {
    rs = hold(t.rs, t.S, lane);
    rc = hold(t.rc, t.S, lane);
  }
  if (held_cl) {
    cs = hold(t.cs, t.CL, lane);
    cc = hold(t.cc, t.CL, lane);
  }

  // rule walk: lane l checks rule start + l of the service's window
  const int s = clampi(s_raw, 0, t.S - 1);
  const int start = held_s ? row_of(rs, s) : t.rs[s];
  const int count = held_s ? row_of(rc, s) : t.rc[s];
  const bool mine = lane < xlb::kRules && lane < count;
  int col = 0, expect = 0, rcl = -1;
  if (mine) {
    const int ix = clampi(start + lane, 0, t.NR - 1);
    const int f = t.rf[ix];
    expect = t.rv[ix];
    rcl = t.rcl[ix];
    col = f < 0 ? f + F : f;                     // a negative column wraps
  }
  const bool inside = col >= 0 && col < F;
  const int from_lane = __shfl_sync(kFull, fw, col & 31);
  const int actual = !inside ? INT_MIN : (col < 32 ? from_lane : row[col]);
  const bool hit = mine && (expect == xlb::kWildcard || expect == actual);
  const unsigned m = __ballot_sync(kFull, hit);
  const int cluster = m ? __shfl_sync(kFull, rcl, __ffs(m) - 1) : -1;

  // least request: lanes lane and lane + 32 of the window, first minimum
  const int cl = clampi(cluster, 0, t.CL - 1);
  const int estart = held_cl ? row_of(cs, cl) : t.cs[cl];
  const int cnt = held_cl ? row_of(cc, cl) : t.cc[cl];
  const int v0 = lane < cnt ? t.load[clampi(estart + lane, 0, t.E - 1)]
                            : kBig;
  const int v1 = lane + 32 < cnt
                     ? t.load[clampi(estart + lane + 32, 0, t.E - 1)]
                     : kBig;
  const int least = __reduce_min_sync(kFull, min(v0, v1));
  const unsigned low = __ballot_sync(kFull, v0 == least);
  const int j = low ? __ffs(low) - 1
                    : __ffs(__ballot_sync(kFull, v1 == least)) + 31;
  if (lane == 0) {
    cluster_out[r] = cluster;
    ep_out[r] = (cluster >= 0 && cnt > 0) ? clampi(estart + j, 0, t.E - 1)
                                          : -1;
  }
}

}  // namespace

extern "C" int xlb_route(const int* svc, const int* feats, int R, int F,
                         const int* rs, const int* rc, const int* rf,
                         const int* rv, const int* rcl, int S, int NR,
                         const int* cs, const int* cc, int CL,
                         const int* load, int E, int* cluster, int* ep,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Tables t{rs, rc, rf, rv, rcl, cs, cc, load, S, NR, CL, E};
  const int blocks = (R + kWarps - 1) / kWarps;
  route_kernel<<<blocks, kBlock, 0, st>>>(svc, feats, R, F, t, cluster, ep);
  return (int)cudaGetLastError();
}
