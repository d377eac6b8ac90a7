// Fused admission (the connect path of one serving tick) for Hopper.
//
// Replaces: src/repro/kernels/route_match.py::_admit_kernel, both modes
// (commit=True behind ops.admit_commit, commit=False behind ops.admit);
// semantics pinned by src/repro/kernels/ref.py::admit_ref and
// admit_commit_ref, policy math by src/repro/core/policy_defs.py.
//
// What bounds it: latency, not bytes or operations.  A batch of R = 256
// requests over a 64 x 16 pool moves well under 100 KB: the request
// columns, the pool (read and written in commit mode), the carried tables,
// and of the rest only what the batch indexes - one Maglev entry per
// maglev/affinity row and the Gumbel lanes of weighted rows.  It does a
// few hundred integer operations per request.  Both are far under one
// launch of this card.  What costs time is the chain of dependent steps:
// each tile's decisions read the counters the previous tile wrote
// (ep_load, rr cursors, per-instance slot cursors, the affinity cache),
// and inside a tile every row's rank depends on the rows before it.
//
// Design: ONE block of kTile threads walks the batch in tiles of kTile
// rows, a thread per row, with every carried counter in shared memory -
// the translation of the Pallas kernel's sequential grid with VMEM
// scratch.  The tile is part of the semantics: every policy hook reads the
// tile-start snapshot of the counters, the in-tile ranks are stable
// arrival-order ranks, and in the affinity cache the first writer of a
// tile wins.  So the tile is the reference's block_r, a template
// parameter built for each size the autotuner may choose (64, 256 and
// 1024 rows; kernels/tune.py).  A 1024-row tile is 1024 threads (32
// warps), not 256 threads walking four rows each: every step below (the
// warp match, the per-warp histograms, the first writer by atomicMin of
// the row) then holds for any tile unchanged, where four rows a thread
// would need a second rank level inside each thread and the snapshot
// reads and folds of four rows in flight.  What that costs is registers:
// __launch_bounds__(1024, 1) leaves a thread 64 of them (PERF.md §6 has
// the spills of each build).  What keeps each row's work O(1):
//   * the small tables are staged into shared memory once per launch with
//     coalesced loads (rules, services, clusters, ep_instance, the drain
//     bits, log(w + 1e-9) per endpoint), and derived once from them: a
//     64-bit eligibility mask per cluster and, per instance, the list of
//     its free slots (the k-th free slot is one read).  The Maglev table
//     (CL x 521 ints) stays in L2, one read per maglev/affinity row,
//     issued right after the match;
//   * in-tile ranks (per cluster, per instance) come from
//     __match_any_sync and a popcount of the lower lanes inside a warp,
//     plus the counts of the earlier warps from per-warp histograms in
//     shared memory; the affinity first writer is an atomicMin of the row
//     index per cache slot;
//   * least request is the water-filling closed form of "argmin, then
//     increment": the row of in-tile cluster rank rho takes the rho-th
//     smallest ticket of {load_j + t : t >= 0} ordered by (value, j).
//     Per tile, one warp per least-request cluster with rows in the tile
//     ranks the 64 window lanes by (tile-start load, lane) and writes, for
//     each k, the tickets below the k-th smallest load (C_k, clamped at
//     kTile) and the mask of the k + 1 smallest lanes; a row then finds
//     its level by a binary search over C and its lane as the
//     ((rho - C_k) mod (k + 1))-th set bit of that mask;
//   * the weighted Gumbel argmax prefetches the row's Gumbel values into
//     L1 right after the match (overlapping the least-request tables),
//     walks only up to the highest eligible lane, branch-free, and adds
//     the staged per-endpoint log(w + 1e-9): the same float value the
//     per-lane call gives, keeping the first-maximum and NaN rules;
//   * every other policy ends in the k-th set bit of a lane mask (rr,
//     random, the Maglev fallback over the eligible lanes; least request
//     over its level's lanes) or in an offset it already holds (a live
//     Maglev entry, an affinity hit): one select by popcounts, not a scan,
//     for all of them.
// Most of the code runs once per launch, so instruction fetch is part of
// the latency: the code is kept small (loops that run once or twice at
// the serving sizes stay rolled), and the prologue issues every global
// load before any store, so that one DRAM round trip serves all the
// tables.
// All-free mode (B3 in the sharded admission): the caller passes no free
// mask and the pool's width W in C.  Every instance then has W free slots
// and the k-th is slot k, so a row's slot is its arrival rank on its
// instance and nothing of the pool is staged: 3 I W bytes of shared memory
// and their staging loop fall away (the mask and the free-slot lists).
// Write-backs go after a barrier, with integer shared-memory atomics
// (order-free, so bit-exact).  Pool cells have one writer each: the slot
// allocator hands out the k-th free slot of an instance to the request of
// global instance rank k.  Built without --use_fast_math: the weighted
// policy needs the accurate logf of log(w + 1e-9) + gumbel or Gumbel ties
// flip.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <type_traits>

#include "bounds.cuh"
#include "match.cuh"

namespace {

using xlb::clampi;
using xlb::Span;
using u64 = unsigned long long;

// kTile (a template parameter): rows per tile == threads per block, built
// for 64, 256 and 1024 (route_match.TILES; xlb_admit dispatches)
constexpr int kWE = 64;          // MAX_EPS_PER_CLUSTER
constexpr int kBig = 1 << 30;    // sentinel load of an ineligible lane
constexpr unsigned kFull = 0xffffffffu;
// policy enum (core/policy_defs.py); round robin (0) is the switch default
constexpr int kRandom = 1, kLeast = 2, kWeighted = 3, kMaglev = 4,
              kAffinity = 5;

// Span<T>: T* in the normal build, a pointer with its extent in the
// bounds-checking one (bounds.cuh).
using CI = Span<const int>;
using I32 = Span<int>;
struct Args {
  CI rid, svc, feats, bytes, rnd;
  Span<const float> gum;
  CI tok;
  int R, F;
  CI rs, rc, rf, rv, rcl;
  int S, NR;
  CI cs, cc, cp;
  int CL;
  CI einst;
  Span<const float> ew;
  CI ed, load0;
  int E;
  CI cur0, mg;
  int T;
  CI affk0, affe0;
  int A;
  Span<const bool> free;  // (I, C) true = free slot (commit: !pool
                          // active); null: an all-free pool (commit-free)
  int I, C;
  CI preq0, pep0, psvc0, plen0, ptok0;
  I32 cluster, ep, inst, slot, ok;
  I32 load_out, cur_out, sreq_out, stx_out, cnt_out, affk_out, affe_out;
  I32 preq, pep, psvc, plen, ptok;
  Span<bool> pact;
};

// Byte offsets of the shared-memory arrays (8-byte arrays first, then 4-,
// 2- and 1-byte ones); `total` is the block's dynamic shared memory.
struct Layout {
  long long emask, lr_mask, wkey;                       // u64
  long long load, held, einst, logw, cur, cs, cc, cp, need, histc, icnt,
      nfree, histi, sreq, stx, rs, rc, rf, rv, rcl, affk, affe, wmin, cnt,
      wload, feat;                                      // 4 bytes
  long long lr_c, fslot;                                // u16
  long long drained, freem;                             // u8
  long long end, total;                                 // end: unpadded
};

__host__ __device__ inline long long take(long long& at, long long n,
                                          int size) {
  const long long o = at;
  at += n * size;
  return o;
}

// all_free: the pool is known to be all free (B3's sharded mode), so
// neither the free mask nor the free-slot lists are staged.  tile: rows
// per tile (its warps' histograms and the staged features grow with it).
__host__ __device__ inline Layout layout(int E, int CL, int S, int NR, int A,
                                         int I, int C, int F, bool all_free,
                                         int tile) {
  const long long IC = all_free ? 0 : (long long)I * C;
  const int kWarps = tile / 32;
  Layout l;
  long long o = 0;
  l.emask = take(o, CL, 8);
  l.lr_mask = take(o, (long long)kWE * CL, 8);
  l.wkey = take(o, kWarps * kWE, 8);
  l.load = take(o, E, 4);
  l.held = take(o, E, 4);
  l.einst = take(o, E, 4);
  l.logw = take(o, E, 4);
  l.cur = take(o, CL, 4);
  l.cs = take(o, CL, 4);
  l.cc = take(o, CL, 4);
  l.cp = take(o, CL, 4);
  l.need = take(o, CL, 4);
  l.histc = take(o, (long long)kWarps * CL, 4);
  l.icnt = take(o, I, 4);
  l.nfree = take(o, I, 4);
  l.histi = take(o, (long long)kWarps * I, 4);
  l.sreq = take(o, S, 4);
  l.stx = take(o, S, 4);
  l.rs = take(o, S, 4);
  l.rc = take(o, S, 4);
  l.rf = take(o, NR, 4);
  l.rv = take(o, NR, 4);
  l.rcl = take(o, NR, 4);
  l.affk = take(o, A, 4);
  l.affe = take(o, A, 4);
  l.wmin = take(o, A, 4);
  l.cnt = take(o, 2, 4);
  l.wload = take(o, kWarps * kWE, 4);
  l.feat = take(o, (long long)tile * (F + 1), 4);
  l.lr_c = take(o, (long long)kWE * CL, 2);
  l.fslot = take(o, IC, 2);
  l.drained = take(o, E, 1);
  l.freem = take(o, IC, 1);
  l.end = o;
  l.total = (o + 15) / 16 * 16;
  return l;
}

struct Shared {
  Span<u64> emask, lr_mask, wkey;
  I32 load, held, einst;
  Span<float> logw;
  I32 cur, cs, cc, cp, need, histc, icnt, nfree, histi, sreq, stx, rs, rc,
      rf, rv, rcl, affk, affe, wmin, cnt, wload, feat;
  Span<unsigned short> lr_c, fslot;
  Span<unsigned char> drained, freem;
};

// Each array from its offset to the next one's (the order of `layout`).
__device__ Shared carve(unsigned char* base, const Layout& l) {
  auto at = [&](auto* type, long long off, long long next) {
    using T = std::remove_pointer_t<decltype(type)>;
    XLB_SMEM(off, next - off);
    return XLB_SPAN(reinterpret_cast<T*>(base + off),
                    (next - off) / (long long)sizeof(T));
  };
  u64* U = nullptr;
  int* N = nullptr;
  Shared s;
  s.emask = at(U, l.emask, l.lr_mask);
  s.lr_mask = at(U, l.lr_mask, l.wkey);
  s.wkey = at(U, l.wkey, l.load);
  s.load = at(N, l.load, l.held);
  s.held = at(N, l.held, l.einst);
  s.einst = at(N, l.einst, l.logw);
  s.logw = at((float*)nullptr, l.logw, l.cur);
  s.cur = at(N, l.cur, l.cs);
  s.cs = at(N, l.cs, l.cc);
  s.cc = at(N, l.cc, l.cp);
  s.cp = at(N, l.cp, l.need);
  s.need = at(N, l.need, l.histc);
  s.histc = at(N, l.histc, l.icnt);
  s.icnt = at(N, l.icnt, l.nfree);
  s.nfree = at(N, l.nfree, l.histi);
  s.histi = at(N, l.histi, l.sreq);
  s.sreq = at(N, l.sreq, l.stx);
  s.stx = at(N, l.stx, l.rs);
  s.rs = at(N, l.rs, l.rc);
  s.rc = at(N, l.rc, l.rf);
  s.rf = at(N, l.rf, l.rv);
  s.rv = at(N, l.rv, l.rcl);
  s.rcl = at(N, l.rcl, l.affk);
  s.affk = at(N, l.affk, l.affe);
  s.affe = at(N, l.affe, l.wmin);
  s.wmin = at(N, l.wmin, l.cnt);
  s.cnt = at(N, l.cnt, l.wload);
  s.wload = at(N, l.wload, l.feat);
  s.feat = at(N, l.feat, l.lr_c);
  s.lr_c = at((unsigned short*)nullptr, l.lr_c, l.fslot);
  s.fslot = at((unsigned short*)nullptr, l.fslot, l.drained);
  s.drained = at((unsigned char*)nullptr, l.drained, l.freem);
  s.freem = at((unsigned char*)nullptr, l.freem, l.end);
  return s;
}

// Floor modulo (Python / torch / jnp semantics), b > 0.
__device__ __forceinline__ int fmodi(int a, int b) {
  int m = a % b;
  return m < 0 ? m + b : m;
}

// Position of the k-th (from 0) set bit of m; 0 when there is none (the
// argmax of an all-false row).  Six popcount steps, no scan.
__device__ __forceinline__ int kth_bit(u64 m, int k) {
  if (k < 0 || k >= __popcll(m)) return 0;
  unsigned x = (unsigned)m;
  int pos = 0, c = __popc(x);
  if (k >= c) {
    k -= c;
    pos = 32;
    x = (unsigned)(m >> 32);
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    c = __popc(x & ((1u << w) - 1u));
    if (k >= c) {
      k -= c;
      pos += w;
      x >>= w;
    }
  }
  return pos;
}

// The least-request table of cluster cl over the tile-start loads, built
// by one warp: the 64 window lanes ranked by (load, lane), an ineligible
// lane at kBig; at rank k, C_k = the tickets below the k-th smallest load
// (k L_k minus the sum of the k smaller loads, clamped at kTile: a rank in
// the tile is below it; the reference clamps at block_r) and the mask of
// the k + 1 smallest lanes.  The ranking is one compare a pair; the sums
// and masks are warp scans over the ranked order.
template <int kTile>
__device__ void build_lr(const Shared& sh, const Args& a, int cl, int lane,
                         int warp) {
  const Span<u64> key = sh.wkey + warp * kWE;   // keys, then the ranked
  const I32 lv = sh.wload + warp * kWE;         // lanes; the ranked loads
  const int start = sh.cs[cl];
  const u64 eok = sh.emask[cl];
  u64 mine[2];
  int ml[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    ml[h] = ((eok >> j) & 1ull) ? sh.load[clampi(start + j, 0, a.E - 1)]
                                : kBig;
    // (load, lane) as one unsigned key: the load's sign bit flipped
    mine[h] = (u64)((unsigned)ml[h] ^ 0x80000000u) << 6 | (unsigned)j;
    key[j] = mine[h];
  }
  __syncwarp();
  int rank[2] = {0, 0};
#pragma unroll 16
  for (int i = 0; i < kWE; ++i) {
    const u64 ki = key[i];
    rank[0] += ki < mine[0];
    rank[1] += ki < mine[1];
  }
  __syncwarp();                        // every key read before the reuse
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lv[rank[h]] = ml[h];
    key[rank[h]] = 1ull << (lane + 32 * h);
  }
  __syncwarp();
  // lane t: ranks 2t and 2t + 1; inclusive scans of the pair's load sum
  // and lane mask
  const int l0 = lv[2 * lane], l1 = lv[2 * lane + 1];
  const u64 b0 = key[2 * lane], b1 = key[2 * lane + 1];
  long long sum = (long long)l0 + l1;
  u64 mask = b0 | b1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long su = __shfl_up_sync(kFull, sum, o);
    const u64 mu = __shfl_up_sync(kFull, mask, o);
    if (lane >= o) {
      sum += su;
      mask |= mu;
    }
  }
  const long long below = sum - l0 - l1;          // loads of ranks < 2t
  const u64 before = mask & ~(b0 | b1);           // lanes of ranks < 2t
  const long long c0 = (long long)(2 * lane) * l0 - below;
  const long long c1 = (long long)(2 * lane + 1) * l1 - below - l0;
  __syncwarp();                        // the buffers serve the next cluster
  sh.lr_c[cl * kWE + 2 * lane] = (unsigned short)(c0 < kTile ? c0 : kTile);
  sh.lr_c[cl * kWE + 2 * lane + 1] =
      (unsigned short)(c1 < kTile ? c1 : kTile);
  sh.lr_mask[cl * kWE + 2 * lane] = before | b0;
  sh.lr_mask[cl * kWE + 2 * lane + 1] = before | b0 | b1;
}

// Weighted: argmax over eligible lanes of log(w + 1e-9) + gumbel; the
// first maximum wins and a NaN counts as the maximum (torch/jnp argmax).
// The walk stops after the highest eligible lane: the lanes past it score
// -inf and can never be taken.  Branch-free: lanes of a warp whose rows
// take different lanes do not diverge.  The row's Gumbel values were
// prefetched into L1 right after the match.
__device__ __forceinline__ int weighted(Span<const float> gum,
                                        Span<float> logw, u64 eok,
                                        int estart, int E) {
  const int n = kWE - __clzll(eok);
  int best_j = 0;
  float best = -INFINITY;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float s = ((eok >> j) & 1ull)
                        ? logw[clampi(estart + j, 0, E - 1)] + __ldg(&gum[j])
                        : -INFINITY;
    const bool take = (j == 0) | (!isnan(best) & (isnan(s) | (s > best)));
    best = take ? s : best;
    best_j = take ? j : best_j;
  }
  return best_j;
}

// Entries a thread loads of a table in the prologue: the 256-row build's
// count `base`, scaled to keep the same entries in flight per block, and
// at most twice it (registers).
__host__ __device__ constexpr int slab(int tile, int base) {
  return base * 256 / tile < 1          ? 1
         : base * 256 / tile > 2 * base ? 2 * base
                                        : base * 256 / tile;
}

// Up to kU entries a thread of one table, held in registers between the
// loads and the stores; entry u of thread t is entry u * kTile + t.
template <int kTile, int kU, typename T>
struct Slab {
  T v[kU];
  template <typename P>
  __device__ __forceinline__ void load(P src, int n, int tid) {
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (u * kTile + tid < n) v[u] = src[u * kTile + tid];
  }
  template <typename P, typename Fn>
  __device__ __forceinline__ void store(P dst, int n, int tid,
                                        Fn fn) const {
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (u * kTile + tid < n) dst[u * kTile + tid] = fn(v[u]);
  }
  // features: flat index k to row k / F of a row stride of F + 1
  __device__ __forceinline__ void store_feat(I32 dst, int n, int F,
                                             int tid) const {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int k = u * kTile + tid;
      if (k < n) dst[k + k / F] = v[u];
    }
  }
};

// Rows [base, base + kTile) of the features into shared memory, rows
// padded to F + 1 ints (no bank conflicts when each thread walks its row);
// the loads of up to 8 ints a thread (a row of N_FEATURES) in flight
// together.
template <int kTile>
__device__ __forceinline__ void stage_features(I32 feat, const Args& a,
                                               int base, int tid) {
  const int n = min(kTile, a.R - base) * a.F;
  const CI src = a.feats + (long long)base * a.F;
  Slab<kTile, 8, int> v;
  v.load(src, n, tid);
  v.store_feat(feat, n, a.F, tid);
#pragma unroll 1
  for (int k = 8 * kTile + tid; k < n; k += kTile) feat[k + k / a.F] = src[k];
}

// One thread's request columns of a tile (row base + tid).
struct Row {
  int rid, svc, bytes, tok;
  template <bool kCommit>
  __device__ __forceinline__ void load(const Args& a, int tid,
                                       int base = 0) {
    const int r = base + tid;
    const bool inb = r < a.R;
    rid = inb ? a.rid[r] : -1;
    svc = inb ? a.svc[r] : 0;
    bytes = inb ? a.bytes[r] : 0;
    tok = kCommit && inb ? a.tok[r] : 0;
  }
};

// kAllFree (commit-free only): the pool is all free with width C = W, so
// instance i's k-th free slot is slot k, a row's slot is its arrival rank
// on its instance, and `free` is not read (it is null).
template <int kTile, bool kCommit, bool kAllFree>
__global__ void __launch_bounds__(kTile, 1) admit_kernel(Args a) {
  static_assert(!(kCommit && kAllFree), "the commit reads its pool");
  constexpr int kWarps = kTile / 32;
  // prologue entries a thread of the (E,)/(A,), (CL,)/(S,)/(NR,) and
  // (I, C) tables
  constexpr int kUE = slab(kTile, 2), kUC = slab(kTile, 1),
                kUP = slab(kTile, 4);
  extern __shared__ __align__(16) unsigned char smem[];
  const Shared sh = carve(smem, layout(a.E, a.CL, a.S, a.NR, a.A, a.I, a.C,
                                       a.F, kAllFree, kTile));
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const unsigned lower = (1u << lane) - 1u;
  const int IC = a.I * a.C, FP = a.F + 1;

  // ---- stage the tables ------------------------------------------------
  // Every global load of the first kU entries a thread of each table (all
  // of them at the serving capacities), of tile 0's features and of its
  // request columns is issued before any store: a store to global memory
  // ahead of a load would keep the load waiting for it.  Larger tables
  // finish in the loops after.
  Slab<kTile, kUE, int> v_load, v_einst, v_ed, v_affk, v_affe;
  Slab<kTile, kUE, float> v_ew;
  Slab<kTile, kUC, int> v_cur, v_cs, v_cc, v_cp, v_rs, v_rc, v_rf, v_rv,
      v_rcl;
  Slab<kTile, kUP, int> v_pool[5];
  Slab<kTile, kUP, bool> v_free;
  Slab<kTile, 8, int> v_feat;
  Row row_in;
  v_load.load(a.load0, a.E, tid);
  v_einst.load(a.einst, a.E, tid);
  v_ed.load(a.ed, a.E, tid);
  v_ew.load(a.ew, a.E, tid);
  v_affk.load(a.affk0, a.A, tid);
  v_affe.load(a.affe0, a.A, tid);
  v_cur.load(a.cur0, a.CL, tid);
  v_cs.load(a.cs, a.CL, tid);
  v_cc.load(a.cc, a.CL, tid);
  v_cp.load(a.cp, a.CL, tid);
  v_rs.load(a.rs, a.S, tid);
  v_rc.load(a.rc, a.S, tid);
  v_rf.load(a.rf, a.NR, tid);
  v_rv.load(a.rv, a.NR, tid);
  v_rcl.load(a.rcl, a.NR, tid);
  if (!kAllFree) v_free.load(a.free, IC, tid);
  if (kCommit) {
    const CI p0[5] = {a.preq0, a.pep0, a.psvc0, a.plen0, a.ptok0};
#pragma unroll
    for (int f = 0; f < 5; ++f) v_pool[f].load(p0[f], IC, tid);
  }
  const int nfeat = min(kTile, a.R) * a.F;
  v_feat.load(a.feats, nfeat, tid);
  row_in.load<kCommit>(a, tid);

  const auto ident = [](auto x) { return x; };
  v_load.store(sh.load, a.E, tid, ident);
  v_einst.store(sh.einst, a.E, tid, ident);
  v_ed.store(sh.drained, a.E, tid,
             [](int x) { return (unsigned char)(x != 0); });
  v_ew.store(sh.logw, a.E, tid,   // the value the per-lane call makes
             [](float w) { return logf(w + 1e-9f); });
  v_affk.store(sh.affk, a.A, tid, ident);
  v_affe.store(sh.affe, a.A, tid, ident);
  v_cur.store(sh.cur, a.CL, tid, ident);
  v_cs.store(sh.cs, a.CL, tid, ident);
  v_cc.store(sh.cc, a.CL, tid, ident);
  v_cp.store(sh.cp, a.CL, tid, ident);
  v_rs.store(sh.rs, a.S, tid, ident);
  v_rc.store(sh.rc, a.S, tid, ident);
  v_rf.store(sh.rf, a.NR, tid, ident);
  v_rv.store(sh.rv, a.NR, tid, ident);
  v_rcl.store(sh.rcl, a.NR, tid, ident);
  if (!kAllFree)
    v_free.store(sh.freem, IC, tid,
                 [](bool f) { return (unsigned char)f; });
  v_feat.store_feat(sh.feat, nfeat, a.F, tid);
#pragma unroll 1
  for (int k = tid; k < a.E; k += kTile) sh.held[k] = 0;
#pragma unroll 1
  for (int k = tid; k < a.CL; k += kTile) sh.need[k] = 0;
#pragma unroll 1
  for (int k = tid; k < kWarps * a.CL; k += kTile) sh.histc[k] = 0;
#pragma unroll 1
  for (int k = tid; k < a.I; k += kTile) sh.icnt[k] = 0;
#pragma unroll 1
  for (int k = tid; k < kWarps * a.I; k += kTile) sh.histi[k] = 0;
#pragma unroll 1
  for (int k = tid; k < a.S; k += kTile) sh.sreq[k] = sh.stx[k] = 0;
#pragma unroll 1
  for (int k = tid; k < a.A; k += kTile) sh.wmin[k] = kTile;
  if (tid < 2) sh.cnt[tid] = 0;
  // the rest of tables larger than the slabs
#pragma unroll 1
  for (int k = kUE * kTile + tid; k < a.E; k += kTile) {
    sh.load[k] = a.load0[k];
    sh.einst[k] = a.einst[k];
    sh.drained[k] = a.ed[k] != 0;
    sh.logw[k] = logf(a.ew[k] + 1e-9f);
  }
#pragma unroll 1
  for (int k = kUE * kTile + tid; k < a.A; k += kTile) {
    sh.affk[k] = a.affk0[k];
    sh.affe[k] = a.affe0[k];
  }
#pragma unroll 1
  for (int k = kUC * kTile + tid; k < a.CL; k += kTile) {
    sh.cur[k] = a.cur0[k];
    sh.cs[k] = a.cs[k];
    sh.cc[k] = a.cc[k];
    sh.cp[k] = a.cp[k];
  }
#pragma unroll 1
  for (int k = kUC * kTile + tid; k < a.S; k += kTile) {
    sh.rs[k] = a.rs[k];
    sh.rc[k] = a.rc[k];
  }
#pragma unroll 1
  for (int k = kUC * kTile + tid; k < a.NR; k += kTile) {
    sh.rf[k] = a.rf[k];
    sh.rv[k] = a.rv[k];
    sh.rcl[k] = a.rcl[k];
  }
#pragma unroll 1
  for (int k = kUP * kTile + tid; !kAllFree && k < IC; k += kTile)
    sh.freem[k] = a.free[k];
#pragma unroll 1
  for (int k = 8 * kTile + tid; k < nfeat; k += kTile)
    sh.feat[k + k / a.F] = a.feats[k];
  if (kCommit) {                  // the pool rides through; admits overwrite
    const I32 p1[5] = {a.preq, a.pep, a.psvc, a.plen, a.ptok};
#pragma unroll
    for (int f = 0; f < 5; ++f) v_pool[f].store(p1[f], IC, tid, ident);
    v_free.store(a.pact, IC, tid, [](bool f) { return !f; });
    const CI p0[5] = {a.preq0, a.pep0, a.psvc0, a.plen0, a.ptok0};
#pragma unroll 1
    for (int k = kUP * kTile + tid; k < IC; k += kTile) {
#pragma unroll
      for (int f = 0; f < 5; ++f) p1[f][k] = p0[f][k];
      a.pact[k] = !a.free[k];
    }
  }
  __syncthreads();

  // ---- derived once: eligibility masks, free-slot lists ----------------
  // a thread per quarter (16 lanes) of a cluster's window; the four
  // quarters of a cluster sit in one warp and join by shuffles
#pragma unroll 1
  for (int q0 = 0; q0 < 4 * a.CL; q0 += kTile) {
    const int t = q0 + tid, c = t >> 2, q = t & 3;
    u64 m = 0ull;
    if (t < 4 * a.CL) {
      const int start = sh.cs[c], count = sh.cc[c];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int e = 16 * q + j;
        m |= (u64)(e < count && !sh.drained[clampi(start + e, 0, a.E - 1)])
             << e;
      }
    }
    m |= __shfl_xor_sync(kFull, m, 1);
    m |= __shfl_xor_sync(kFull, m, 2);
    if (t < 4 * a.CL && q == 0) sh.emask[c] = m;
  }
  // a thread per instance: its free slots in order
#pragma unroll 1
  for (int i = tid; !kAllFree && i < a.I; i += kTile) {
    int n = 0;
#pragma unroll 4
    for (int c = 0; c < a.C; ++c)
      if (sh.freem[i * a.C + c]) sh.fslot[i * a.C + n++] = (unsigned short)c;
    sh.nfree[i] = n;
  }
  __syncthreads();

  for (int base = 0; base < a.R; base += kTile) {
    const int r = base + tid;
    const bool inb = r < a.R;
    const I32 row = sh.feat + tid * FP;

    // ---- content match, flow key, and the hooks' global reads ----------
    const Row in = row_in;              // this tile's request columns
    const int rid = in.rid;
    const int svc_raw = in.svc;
    const bool valid = inb && rid >= 0;
    const int svc = clampi(svc_raw, 0, a.S - 1);
    int fkey = 0;
    if (inb) {
      unsigned h = 0x811C9DC5u;
      for (int j = 0; j < a.F; ++j) h = (h ^ (unsigned)row[j]) * 0x01000193u;
      fkey = (int)(h & 0x7FFFFFFFu);
    }
    const int cluster =
        valid ? xlb::match_rule(row, a.F, svc, sh.rs, sh.rc, sh.rf, sh.rv,
                                sh.rcl, a.NR)
              : -1;
    const int cl = clampi(cluster, 0, a.CL - 1);
    const int count = sh.cc[cl], estart = sh.cs[cl], policy = sh.cp[cl];
    const u64 eok = sh.emask[cl];              // in window, not draining
    const int cnt2 = __popcll(eok);
    const int cnt1 = max(cnt2, 1);
    const bool routable = valid && cluster >= 0 && cnt2 > 0;
    const int nbytes = in.bytes, tok = in.tok;
    const int rnd = routable && policy == kRandom ? a.rnd[r] : 0;
    const int mg_t = routable && (policy == kMaglev || policy == kAffinity)
                         ? a.mg[(long long)cl * a.T + fmodi(fkey, a.T)]
                         : 0;
    const Span<const float> gum = a.gum + (long long)r * kWE;
    if (routable && policy == kWeighted) {   // its two 128-byte lines
      const float* g = xlb::raw(gum);
      asm volatile("prefetch.global.L1 [%0];" ::"l"(g));
      asm volatile("prefetch.global.L1 [%0];" ::"l"(g + 32));
    }

    // in-warp cluster rank; each warp's count per cluster for the others
    const unsigned peers_c = __match_any_sync(kFull, routable ? cl : -1);
    const bool lead_c = routable && __ffs(peers_c) - 1 == lane;
    if (lead_c) sh.histc[warp * a.CL + cl] = __popc(peers_c);
    const bool lr = routable && policy == kLeast;
    if (lr) sh.need[cl] = 1;
    if (__syncthreads_or(lr)) {
      // ---- least-request tables: a warp per cluster with rows here -----
      int seen = 0;
      for (int c0 = 0; c0 < a.CL; c0 += 32) {
        unsigned b = __ballot_sync(kFull,
                                   c0 + lane < a.CL && sh.need[c0 + lane]);
        while (b) {
          const int c = c0 + __ffs(b) - 1;
          b &= b - 1;
          if (seen++ % kWarps == warp) build_lr<kTile>(sh, a, c, lane, warp);
        }
      }
      __syncthreads();
    }

    // ---- policy dispatch over the tile-start snapshot ------------------
    int rank_c = __popc(peers_c & lower);
#pragma unroll
    for (int w = 0; w < kWarps - 1; ++w)
      rank_c += w < warp ? sh.histc[w * a.CL + cl] : 0;
    const int aslot = fmodi(fkey, a.A);
    const int ak = sh.affk[aslot], ae = sh.affe[aslot];
    const bool hit = ak == fkey && ae >= estart && ae < estart + count &&
                     !sh.drained[clampi(ae, 0, a.E - 1)];
    // every policy but weighted ends in the k-th set bit of a lane mask,
    // or in an offset it already holds: one select for all of them
    const bool mg_ok = mg_t >= 0 && mg_t < count &&
                       !sh.drained[clampi(estart + mg_t, 0, a.E - 1)];
    int off = 0;
    if (routable && policy == kWeighted) {
      off = weighted(gum, sh.logw, eok, estart, a.E);
    } else if (routable) {
      u64 mask = eok;
      int x = sh.cur[cl] + rank_c;   // round robin, also an unknown policy
      int direct = -1;               // an offset that needs no select
      if (policy == kRandom) x = rnd;
      if (policy == kMaglev || policy == kAffinity) {
        x = fkey;                    // the fallback: the (fkey mod n)-th lane
        direct = policy == kAffinity && hit ? ae - estart
                 : mg_ok                   ? mg_t
                                           : -1;
      }
      int k;
      if (policy == kLeast) {
        // the row of in-tile cluster rank rho (< kTile) owns the rho-th
        // smallest ticket: its level is that of the largest lv with
        // C_lv <= rho, and it is the ((rho - C_lv) mod (lv + 1))-th of
        // the lv + 1 lanes at or below it, in lane order
        const Span<unsigned short> c = sh.lr_c + cl * kWE;
        int lv = 0;
#pragma unroll
        for (int step = kWE / 2; step > 0; step >>= 1)
          if (c[lv + step] <= rank_c) lv += step;
        mask = sh.lr_mask[cl * kWE + lv];
        k = (rank_c - c[lv]) % (lv + 1);
      } else {
        k = fmodi(x, cnt1);
      }
      off = direct >= 0 ? direct : kth_bit(mask, k);
    }
    int ep = -1;
    if (routable)
      ep = (off >= 0 && off < kWE) ? clampi(estart + off, 0, a.E - 1)
                                   : INT_MIN;
    const int epc = max(ep, 0);
    const int inst = routable ? sh.einst[epc] : -1;
    const int instc = clampi(inst, 0, a.I - 1);
    const bool want = routable && policy == kAffinity && !hit &&
                      (ak == -1 || ak == fkey);
    const unsigned peers_i = __match_any_sync(kFull, routable ? instc : -1);
    const bool lead_i = routable && __ffs(peers_i) - 1 == lane;
    if (lead_i) sh.histi[warp * a.I + instc] = __popc(peers_i);
    if (want) atomicMin(&sh.wmin[aslot], tid);  // first writer per slot
    const int icnt0 = sh.icnt[instc];
    __syncthreads();

    // ---- free-slot allocation: the k-th free slot per instance ---------
    int rank_i = icnt0 + __popc(peers_i & lower);
#pragma unroll
    for (int w = 0; w < kWarps - 1; ++w)
      rank_i += w < warp ? sh.histi[w * a.I + instc] : 0;
    const bool ok = routable && rank_i < (kAllFree ? a.C : sh.nfree[instc]);
    const int slot =
        !ok ? -1 : kAllFree ? rank_i : sh.fslot[instc * a.C + rank_i];
    const bool held = routable && !ok;
    if (inb) {
      a.cluster[r] = valid ? cluster : -1;
      a.ep[r] = ep;
      a.inst[r] = inst;
      a.slot[r] = slot;
      a.ok[r] = ok;
    }
    if (kCommit && ok) {
      const int cell = instc * a.C + slot;
      a.preq[cell] = rid;
      a.pep[cell] = ep;
      a.psvc[cell] = svc_raw;        // raw svc, as the engine stores it
      a.plen[cell] = 0;
      a.ptok[cell] = tok;
      a.pact[cell] = true;
    }
    const bool first = want && sh.wmin[aslot] == tid;
    if (first) {                     // every snapshot read of it is done
      sh.affk[aslot] = fkey;
      sh.affe[aslot] = ep;
    }
    __syncthreads();                 // every rank and snapshot read is done

    // ---- carried state: folds into shared memory -----------------------
    if (first) sh.wmin[aslot] = kTile;
    if (lr) sh.need[cl] = 0;
    if (lead_c) {
      atomicAdd(&sh.cur[cl], __popc(peers_c));   // raw count, reduced at emit
      sh.histc[warp * a.CL + cl] = 0;
    }
    if (lead_i) {
      atomicAdd(&sh.icnt[instc], __popc(peers_i));
      sh.histi[warp * a.I + instc] = 0;
    }
    if (routable) atomicAdd(&sh.load[epc], 1);
    if (held) atomicAdd(&sh.held[epc], 1);
    if (ok && svc_raw < a.S) {       // metrics drop svc >= S
      atomicAdd(&sh.sreq[svc], 1);
      atomicAdd(&sh.stx[svc], nbytes);
    }
    const unsigned n_held = __ballot_sync(kFull, held);
    const unsigned n_miss = __ballot_sync(kFull, valid && cluster < 0);
    if (lane == 0) {
      if (n_held) atomicAdd(&sh.cnt[1], __popc(n_held));
      if (n_miss) atomicAdd(&sh.cnt[0], __popc(n_miss));
    }
    if (base + kTile < a.R) {
      stage_features<kTile>(sh.feat, a, base + kTile, tid);
      row_in.load<kCommit>(a, tid, base + kTile);
    }
    __syncthreads();
  }

  // ---- emit: held requests release their load; cursors reduce ----------
#pragma unroll 1
  for (int k = tid; k < a.E; k += kTile)
    a.load_out[k] = sh.load[k] - sh.held[k];
#pragma unroll 1
  for (int k = tid; k < a.CL; k += kTile)
    a.cur_out[k] = fmodi(sh.cur[k], max(sh.cc[k], 1));
#pragma unroll 1
  for (int k = tid; k < a.S; k += kTile) {
    a.sreq_out[k] = sh.sreq[k];
    a.stx_out[k] = sh.stx[k];
  }
  if (tid < 2) a.cnt_out[tid] = sh.cnt[tid];
#pragma unroll 1
  for (int k = tid; k < a.A; k += kTile) {
    a.affk_out[k] = sh.affk[k];
    a.affe_out[k] = sh.affe[k];
  }
}

// The three modes of one tile's build: commit, masked, all-free.
template <int kTile>
cudaError_t set_optin(int optin) {
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaFuncSetAttribute(admit_kernel<kTile, true, false>,
                                         attr, optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(admit_kernel<kTile, false, false>, attr,
                               optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(admit_kernel<kTile, false, true>, attr,
                               optin);
  return err;
}

template <int kTile>
void launch(const Args& a, int smem, cudaStream_t st, bool commit,
            bool all_free) {
  if (commit)
    admit_kernel<kTile, true, false><<<1, kTile, smem, st>>>(a);
  else if (all_free)
    admit_kernel<kTile, false, true><<<1, kTile, smem, st>>>(a);
  else
    admit_kernel<kTile, false, false><<<1, kTile, smem, st>>>(a);
}

}  // namespace

// Bytes of dynamic shared memory one launch at tile `tile` takes.
extern "C" int xlb_admit_smem_bytes(int E, int CL, int S, int NR, int A,
                                    int I, int C, int F, int all_free,
                                    int tile) {
  const long long bytes =
      layout(E, CL, S, NR, A, I, C, F, all_free != 0, tile).total;
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

extern "C" const char* xlb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Opts the nine instantiations (three tiles, three modes) in to all the
// shared memory a block of the current device may have; called once per
// device before the first launch.
extern "C" int xlb_admit_init() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = set_optin<64>(optin);
  if (err == cudaSuccess) err = set_optin<256>(optin);
  if (err == cudaSuccess) err = set_optin<1024>(optin);
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
    int commit, int tile, void* stream) {
  // a null free mask: the all-free mode of the commit-free kernel
  const bool all_free = free == nullptr;
  if (all_free && commit) return (int)cudaErrorInvalidValue;
  const long long IC = (long long)I * C;
  Args a{XLB_SPAN(rid, R), XLB_SPAN(svc, R), XLB_SPAN(feats, (long long)R * F),
         XLB_SPAN(bytes, R), XLB_SPAN(rnd, R),
         XLB_SPAN(gum, (long long)R * kWE), XLB_SPAN(tok, tok ? R : 0), R, F,
         XLB_SPAN(rs, S), XLB_SPAN(rc, S), XLB_SPAN(rf, NR), XLB_SPAN(rv, NR),
         XLB_SPAN(rcl, NR), S, NR, XLB_SPAN(cs, CL), XLB_SPAN(cc, CL),
         XLB_SPAN(cp, CL), CL, XLB_SPAN(einst, E), XLB_SPAN(ew, E),
         XLB_SPAN(ed, E), XLB_SPAN(load0, E), E, XLB_SPAN(cur0, CL),
         XLB_SPAN(mg, (long long)CL * T), T, XLB_SPAN(affk0, A),
         XLB_SPAN(affe0, A), A, XLB_SPAN(free, free ? IC : 0), I, C,
         XLB_SPAN(preq0, commit ? IC : 0), XLB_SPAN(pep0, commit ? IC : 0),
         XLB_SPAN(psvc0, commit ? IC : 0), XLB_SPAN(plen0, commit ? IC : 0),
         XLB_SPAN(ptok0, commit ? IC : 0), XLB_SPAN(cluster, R),
         XLB_SPAN(ep, R), XLB_SPAN(inst, R), XLB_SPAN(slot, R),
         XLB_SPAN(ok, R), XLB_SPAN(load_out, E), XLB_SPAN(cur_out, CL),
         XLB_SPAN(sreq, S), XLB_SPAN(stx, S), XLB_SPAN(cnt, 2),
         XLB_SPAN(affk, A), XLB_SPAN(affe, A),
         XLB_SPAN(preq, commit ? IC : 0), XLB_SPAN(pep, commit ? IC : 0),
         XLB_SPAN(psvc, commit ? IC : 0), XLB_SPAN(plen, commit ? IC : 0),
         XLB_SPAN(ptok, commit ? IC : 0), XLB_SPAN(pact, commit ? IC : 0)};
  const int smem =
      xlb_admit_smem_bytes(E, CL, S, NR, A, I, C, F, all_free, tile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {   // rows per tile: one of the builds, else refused
    case 64:
      launch<64>(a, smem, st, commit, all_free);
      break;
    case 256:
      launch<256>(a, smem, st, commit, all_free);
      break;
    case 1024:
      launch<1024>(a, smem, st, commit, all_free);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
