// Fused admission (the connect path of one serving tick) for Hopper.
//
// Replaces: src/repro/kernels/route_match.py::_admit_kernel, both modes
// (commit=True behind ops.admit_commit, commit=False behind ops.admit);
// semantics pinned by src/repro/kernels/ref.py::admit_ref and
// admit_commit_ref, policy math by src/repro/core/policy_defs.py.
//
// What bounds it: launch latency and the sequential dependence between
// tiles, not bytes or operations.  A batch of R = 256 requests over a
// 64 x 16 pool moves well under 100 KB: the request columns, the pool
// (read and written in commit mode), the carried tables, and of the rest
// only what the batch indexes - one Maglev entry per maglev/affinity row
// and the eligible Gumbel lanes of weighted rows.  It does a few hundred
// integer operations per request.  Both are far under one launch of this
// card.  What costs time is that each tile's decisions read the counters
// the previous tile wrote (ep_load, rr cursors, per-instance slot
// cursors, the affinity cache).
//
// Design: ONE thread block loops over the batch in tiles of kTile rows,
// one thread per request, with every carried counter in shared memory -
// the translation of the Pallas kernel's sequential grid with VMEM
// scratch.  Every policy hook reads the tile-start snapshot of the
// counters; the in-tile ranks (per cluster, per instance, per affinity
// slot) are stable arrival-order ranks computed by counting earlier rows
// of the tile.  Write-backs go after a __syncthreads(), with integer
// shared-memory atomics (order-free, so bit-exact).  Pool cells have one
// writer each: the slot allocator hands out the k-th free slot of an
// instance to the request of global instance rank k.  The Maglev table
// (64 x 521 ints) stays in global memory and L2.  A single block is slow
// by design; a many-block counting-sort formulation is later work.
// Built without --use_fast_math: the weighted policy needs the accurate
// logf of log(w + 1e-9) + gumbel or Gumbel ties flip.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

#include "match.cuh"

namespace {

using xlb::clampi;

constexpr int kTile = 256;       // rows per tile == threads per block
constexpr int kWE = 64;          // MAX_EPS_PER_CLUSTER
constexpr int kBig = 1 << 30;    // sentinel load of an ineligible lane
// policy enum (core/policy_defs.py); round robin (0) is the switch default
constexpr int kRandom = 1, kLeast = 2, kWeighted = 3, kMaglev = 4,
              kAffinity = 5;

struct Args {
  const int *rid, *svc, *feats, *bytes, *rnd;
  const float* gum;
  const int* tok;
  int R, F;
  const int *rs, *rc, *rf, *rv, *rcl;
  int S, NR;
  const int *cs, *cc, *cp;
  int CL;
  const int* einst;
  const float* ew;
  const int *ed, *load0;
  int E;
  const int *cur0, *mg;
  int T;
  const int *affk0, *affe0;
  int A;
  const bool* free;   // (I, C) true = free slot (commit: !pool active)
  int I, C;
  const int *preq0, *pep0, *psvc0, *plen0, *ptok0;
  int *cluster, *ep, *inst, *slot, *ok;
  int *load_out, *cur_out, *sreq_out, *stx_out, *cnt_out, *affk_out,
      *affe_out;
  int *preq, *pep, *psvc, *plen, *ptok;
  bool* pact;
};

// Floor modulo (Python / torch / jnp semantics), b > 0.
__device__ __forceinline__ int fmodi(int a, int b) {
  int m = a % b;
  return m < 0 ? m + b : m;
}

// Window offset of the k-th eligible endpoint (0 when there is none: the
// argmax of an all-false row).
__device__ __forceinline__ int kth(unsigned long long eok, int k) {
  int c = 0;
  for (int j = 0; j < kWE; ++j) {
    if ((eok >> j) & 1ull) {
      if (c == k) return j;
      ++c;
    }
  }
  return 0;
}

struct Shared {
  int *load, *held, *cur, *icnt, *nfree, *sreq, *stx, *cnt, *affk, *affe;
  int *ta, *tb, *tc;
  unsigned char* freem;
};

__device__ Shared carve(int* base, int E, int CL, int S, int A, int I) {
  Shared s;
  s.load = base;          base += E;
  s.held = base;          base += E;
  s.cur = base;           base += CL;
  s.icnt = base;          base += I;
  s.nfree = base;         base += I;
  s.sreq = base;          base += S;
  s.stx = base;           base += S;
  s.cnt = base;           base += 2;
  s.affk = base;          base += A;
  s.affe = base;          base += A;
  s.ta = base;            base += kTile;
  s.tb = base;            base += kTile;
  s.tc = base;            base += kTile;
  s.freem = reinterpret_cast<unsigned char*>(base);
  return s;
}

// Least request: the request with in-tile cluster rank rho owns the
// rho-th smallest ticket of {load_j + t : t >= 0} ordered by (value, j).
__device__ int least_request(const Shared& sh, const Args& a,
                             unsigned long long eok, int estart, int rank) {
  auto lane = [&](int j) -> int {
    return ((eok >> j) & 1ull) ? sh.load[clampi(estart + j, 0, a.E - 1)]
                               : kBig;
  };
  int lo = kBig;
  for (int j = 0; j < kWE; ++j) lo = min(lo, lane(j));
  int hi = lo + rank;
  long long tgt = rank + 1;
  while (lo < hi) {
    int mid = lo + (hi - lo) / 2;
    long long n = 0;
    for (int j = 0; j < kWE; ++j) n += max(mid - lane(j) + 1, 0);
    if (n >= tgt) hi = mid; else lo = mid + 1;
  }
  long long below = 0;
  for (int j = 0; j < kWE; ++j) below += max(lo - lane(j), 0);
  long long m = rank - below;                 // rank among value-lo ties
  long long c = 0;
  for (int j = 0; j < kWE; ++j) {
    if (lane(j) <= lo) {
      if (c == m) return j;
      ++c;
    }
  }
  return 0;
}

// Weighted: argmax over eligible lanes of log(w + 1e-9) + gumbel; the
// first maximum wins and a NaN counts as the maximum (torch/jnp argmax).
__device__ int weighted(const Args& a, unsigned long long eok, int estart,
                        int r) {
  int best_j = 0;
  float best = 0.f;
  for (int j = 0; j < kWE; ++j) {
    float s = -INFINITY;
    if ((eok >> j) & 1ull) {
      float w = a.ew[clampi(estart + j, 0, a.E - 1)];
      s = logf(w + 1e-9f) + a.gum[(long long)r * kWE + j];
    }
    if (j == 0) { best = s; continue; }
    if (isnan(best)) break;
    if (isnan(s) || s > best) { best = s; best_j = j; }
  }
  return best_j;
}

__device__ int maglev(const Args& a, unsigned long long eok, int cl,
                      int estart, int count, int cnt1, int fkey) {
  int t = a.mg[(long long)cl * a.T + fmodi(fkey, a.T)];
  int te = clampi(estart + t, 0, a.E - 1);
  bool ok = t >= 0 && t < count && a.ed[te] == 0;
  return ok ? t : kth(eok, fmodi(fkey, cnt1));
}

template <bool kCommit>
__global__ void __launch_bounds__(kTile) admit_kernel(Args a) {
  extern __shared__ int smem[];
  const int tid = threadIdx.x;
  Shared sh = carve(smem, a.E, a.CL, a.S, a.A, a.I);
  const int IC = a.I * a.C;

  for (int k = tid; k < a.E; k += kTile) {
    sh.load[k] = a.load0[k];
    sh.held[k] = 0;
  }
  for (int k = tid; k < a.CL; k += kTile) sh.cur[k] = a.cur0[k];
  for (int k = tid; k < a.I; k += kTile) sh.icnt[k] = 0;
  for (int k = tid; k < a.S; k += kTile) sh.sreq[k] = sh.stx[k] = 0;
  if (tid < 2) sh.cnt[tid] = 0;
  for (int k = tid; k < a.A; k += kTile) {
    sh.affk[k] = a.affk0[k];
    sh.affe[k] = a.affe0[k];
  }
  for (int k = tid; k < IC; k += kTile) {
    bool f = a.free[k];
    sh.freem[k] = f;
    if (kCommit) {              // the pool rides through; admits overwrite
      a.preq[k] = a.preq0[k];
      a.pep[k] = a.pep0[k];
      a.psvc[k] = a.psvc0[k];
      a.plen[k] = a.plen0[k];
      a.ptok[k] = a.ptok0[k];
      a.pact[k] = !f;
    }
  }
  __syncthreads();
  for (int i = tid; i < a.I; i += kTile) {
    int n = 0;
    for (int c = 0; c < a.C; ++c) n += sh.freem[i * a.C + c];
    sh.nfree[i] = n;
  }
  __syncthreads();

  for (int base = 0; base < a.R; base += kTile) {
    const int r = base + tid;
    const bool inb = r < a.R;
    const bool valid = inb && a.rid[r] >= 0;
    const int svc_raw = inb ? a.svc[r] : 0;
    const int svc = clampi(svc_raw, 0, a.S - 1);

    // ---- content match: first matching rule of the service's chain ----
    const int cluster =
        valid ? xlb::match_rule(a.feats + (long long)r * a.F, a.F, svc, a.rs,
                                a.rc, a.rf, a.rv, a.rcl, a.NR)
              : -1;
    const int cl = clampi(cluster, 0, a.CL - 1);
    const int count = a.cc[cl], estart = a.cs[cl], policy = a.cp[cl];
    unsigned long long eok = 0ull;   // eligible: in window, not draining
    for (int j = 0; j < kWE && j < count; ++j)
      if (a.ed[clampi(estart + j, 0, a.E - 1)] == 0) eok |= 1ull << j;
    const int cnt2 = __popcll(eok);
    const int cnt1 = max(cnt2, 1);
    const bool routable = valid && cluster >= 0 && cnt2 > 0;
    int fkey = 0;
    if (inb) {
      unsigned h = 0x811C9DC5u;
      for (int j = 0; j < a.F; ++j)
        h = (h ^ (unsigned)a.feats[(long long)r * a.F + j]) * 0x01000193u;
      fkey = (int)(h & 0x7FFFFFFFu);
    }

    sh.ta[tid] = routable ? cl : -1;
    __syncthreads();
    int rank_c = 0;
    if (routable)
      for (int j = 0; j < tid; ++j) rank_c += sh.ta[j] == cl;

    // ---- policy dispatch over the tile-start snapshot ------------------
    const int aslot = fmodi(fkey, a.A);
    const int ak = sh.affk[aslot], ae = sh.affe[aslot];
    const bool hit = ak == fkey && ae >= estart && ae < estart + count &&
                     a.ed[clampi(ae, 0, a.E - 1)] == 0;
    int off = 0;
    if (routable) {
      switch (policy) {
        case kRandom: off = kth(eok, fmodi(a.rnd[r], cnt1)); break;
        case kLeast:
          off = least_request(sh, a, eok, estart, rank_c);
          break;
        case kWeighted: off = weighted(a, eok, estart, r); break;
        case kMaglev:
          off = maglev(a, eok, cl, estart, count, cnt1, fkey);
          break;
        case kAffinity:
          off = hit ? ae - estart
                    : maglev(a, eok, cl, estart, count, cnt1, fkey);
          break;
        default:               // round robin, also for an unknown policy
          off = kth(eok, fmodi(sh.cur[cl] + rank_c, cnt1));
      }
    }
    int ep = -1;
    if (routable)
      ep = (off >= 0 && off < kWE) ? clampi(estart + off, 0, a.E - 1)
                                   : INT_MIN;
    const int epc = max(ep, 0);
    const int inst = routable ? a.einst[epc] : -1;
    const int instc = clampi(inst, 0, a.I - 1);
    const bool want = routable && policy == kAffinity && !hit &&
                      (ak == -1 || ak == fkey);

    // ---- free-slot allocation: the k-th free slot per instance ---------
    sh.tb[tid] = routable ? instc : -1;
    sh.tc[tid] = want ? aslot : -1;
    __syncthreads();
    int rank_i = 0, rank_w = 0;
    for (int j = 0; j < tid; ++j) {
      rank_i += routable && sh.tb[j] == instc;
      rank_w += want && sh.tc[j] == aslot;
    }
    rank_i += routable ? sh.icnt[instc] : 0;
    const bool ok = routable && rank_i < sh.nfree[instc];
    int slot = -1;
    if (ok) {
      int k = 0;
      for (int c = 0; c < a.C; ++c) {
        if (sh.freem[instc * a.C + c]) {
          if (k == rank_i) { slot = c; break; }
          ++k;
        }
      }
    }
    const bool held = routable && !ok;
    if (inb) {
      a.cluster[r] = valid ? cluster : -1;
      a.ep[r] = ep;
      a.inst[r] = inst;
      a.slot[r] = slot;
      a.ok[r] = ok;
    }
    if (kCommit && ok) {
      int cell = instc * a.C + slot;
      a.preq[cell] = a.rid[r];
      a.pep[cell] = ep;
      a.psvc[cell] = svc_raw;        // raw svc, as the engine stores it
      a.plen[cell] = 0;
      a.ptok[cell] = a.tok[r];
      a.pact[cell] = true;
    }
    __syncthreads();                 // every snapshot read is done

    // ---- carried state: folds into shared memory -----------------------
    if (want && rank_w == 0) {       // first writer per slot wins
      sh.affk[aslot] = fkey;
      sh.affe[aslot] = ep;
    }
    if (routable) {
      atomicAdd(&sh.load[epc], 1);
      atomicAdd(&sh.cur[cl], 1);     // raw count, reduced at emit
      atomicAdd(&sh.icnt[instc], 1);
    }
    if (held) {
      atomicAdd(&sh.held[epc], 1);
      atomicAdd(&sh.cnt[1], 1);
    }
    if (ok && svc_raw < a.S) {       // metrics drop svc >= S
      atomicAdd(&sh.sreq[svc], 1);
      atomicAdd(&sh.stx[svc], a.bytes[r]);
    }
    if (valid && cluster < 0) atomicAdd(&sh.cnt[0], 1);
    __syncthreads();
  }

  // ---- emit: held requests release their load; cursors reduce ----------
  for (int k = tid; k < a.E; k += kTile)
    a.load_out[k] = sh.load[k] - sh.held[k];
  for (int k = tid; k < a.CL; k += kTile)
    a.cur_out[k] = fmodi(sh.cur[k], max(a.cc[k], 1));
  for (int k = tid; k < a.S; k += kTile) {
    a.sreq_out[k] = sh.sreq[k];
    a.stx_out[k] = sh.stx[k];
  }
  if (tid < 2) a.cnt_out[tid] = sh.cnt[tid];
  for (int k = tid; k < a.A; k += kTile) {
    a.affk_out[k] = sh.affk[k];
    a.affe_out[k] = sh.affe[k];
  }
}

}  // namespace

extern "C" int xlb_admit_smem_bytes(int E, int CL, int S, int A, int I,
                                    int C) {
  long long ints = 2LL * E + CL + 2LL * I + 2LL * S + 2 + 2LL * A + 3 * kTile;
  long long bytes = 4 * ints + (long long)I * C;
  bytes = (bytes + 15) / 16 * 16;
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

extern "C" const char* xlb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Opts both instantiations in to all the shared memory a block of the
// current device may have; called once per device before the first launch.
extern "C" int xlb_admit_init() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(admit_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(admit_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  return (int)err;
}

extern "C" int xlb_admit(
    const int* rid, const int* svc, const int* feats, const int* bytes,
    const int* rnd, const float* gum, const int* tok, int R, int F,
    const int* rs, const int* rc, const int* rf, const int* rv,
    const int* rcl, int S, int NR,
    const int* cs, const int* cc, const int* cp, int CL,
    const int* einst, const float* ew, const int* ed, const int* load0,
    int E, const int* cur0, const int* mg, int T,
    const int* affk0, const int* affe0, int A,
    const bool* free, int I, int C,
    const int* preq0, const int* pep0, const int* psvc0, const int* plen0,
    const int* ptok0,
    int* cluster, int* ep, int* inst, int* slot, int* ok,
    int* load_out, int* cur_out, int* sreq, int* stx, int* cnt,
    int* affk, int* affe,
    int* preq, int* pep, int* psvc, int* plen, int* ptok, bool* pact,
    int commit, void* stream) {
  Args a{rid, svc, feats, bytes, rnd, gum, tok, R, F, rs, rc, rf, rv, rcl,
         S, NR, cs, cc, cp, CL, einst, ew, ed, load0, E, cur0, mg, T,
         affk0, affe0, A, free, I, C, preq0, pep0, psvc0, plen0, ptok0,
         cluster, ep, inst, slot, ok, load_out, cur_out, sreq, stx, cnt,
         affk, affe, preq, pep, psvc, plen, ptok, pact};
  int smem = xlb_admit_smem_bytes(E, CL, S, A, I, C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (commit)
    admit_kernel<true><<<1, kTile, smem, st>>>(a);
  else
    admit_kernel<false><<<1, kTile, smem, st>>>(a);
  return (int)cudaGetLastError();
}
