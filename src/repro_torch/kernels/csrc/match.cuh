// The content-match stage shared by the admission kernel (admit.cu) and
// the route kernel (route.cu): one request's bounded walk of its service's
// rule chain, first matching rule wins.
//
// Semantics: src/repro/kernels/route_match.py::_match_stage.  The rule
// window is clamped into the rule table, a rule's feature column follows
// jnp.take_along_axis (a negative column wraps once, a column still
// outside [0, F) reads INT_MIN, the gather's fill value), and a rule whose
// expected value is the wildcard matches anything.

#pragma once

#include <climits>

namespace xlb {

constexpr int kRules = 16;       // MAX_RULES_PER_SVC
constexpr int kWildcard = -1;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Feature column f of one request row of F features.
__device__ __forceinline__ int feature(const int* row, int F, int f) {
  if (f < 0) f += F;
  if (f < 0 || f >= F) return INT_MIN;
  return row[f];
}

// Destination cluster of the first rule of service ``svc`` (already in
// [0, S)) that the row matches; -1 when none does.  rs/rc: per-service
// rule window start/count; rf/rv/rcl: the NR rules' feature column,
// expected value and cluster.
__device__ __forceinline__ int match_rule(const int* row, int F, int svc,
                                          const int* rs, const int* rc,
                                          const int* rf, const int* rv,
                                          const int* rcl, int NR) {
  const int start = rs[svc], count = rc[svc];
  for (int t = 0; t < kRules && t < count; ++t) {
    const int ix = clampi(start + t, 0, NR - 1);
    const int expect = rv[ix];
    if (expect == kWildcard || expect == feature(row, F, rf[ix]))
      return rcl[ix];
  }
  return -1;
}

}  // namespace xlb
