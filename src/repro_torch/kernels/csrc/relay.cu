// Relay slot assignment (counting-sort rank) for Hopper.
//
// Replaces: src/repro/kernels/relay_dispatch.py::_relay_kernel (behind
// ops.relay_slots); semantics pinned by src/repro/core/relay.py::
// positions_sort.  For each row r with destination d = idx[r] in
// [0, n_dest): slot[r] = the number of earlier rows with the same
// destination (a stable rank), and load[d] = the rows destined to d.
// Rows with any other destination (the sentinel n_dest) take no rank and
// count no load; their slot is outside the contract and written as 0.
//
// What bounds it: latency, not bytes (the staged chain's batches move a
// few KB): a row's rank depends on every earlier row.
//
// Design: tiles of kTile rows, one thread per row, 8 warps.
// - Rank within a warp: __match_any_sync on the destination gives the
//   row's peers; the peers below its lane are its rank in the warp.
// - Rank across the warps of a tile: per destination one 64-bit shared
//   word, byte w holding warp w's group size (<= 32).  Each group's lowest
//   lane stores its byte (no atomics: every warp owns its byte); after one
//   barrier a row sums the bytes below its warp (a multiply) and adds the
//   running count of earlier tiles, base[d].  O(1) per row.
// - A block walking several tiles adds each tile's total to base[d] (one
//   lane per destination: the group leader of the lowest warp holding it)
//   and clears the bytes after a second barrier.
// - Many blocks once N exceeds a tile: the blocks form ONE thread-block
//   cluster (up to kMaxBlocks, the portable cluster size), each walking a
//   contiguous range of tiles.  After the walk every block's base[] holds
//   its per-destination totals; the blocks read each other's through
//   distributed shared memory (the exclusive prefix over lower blocks, and
//   load from all of them) and the blocks past the first add their prefix
//   to their rows' slots.  A cluster needs no global scratch, no flags
//   and no memset, and keeps the call one launch; the price is that the
//   parallelism stops at 8 SMs, so past 8 tiles each block walks more.
// - N <= kTile (the staged chain's batches): one block, one barrier.
// Integer sums only, so every result is bit-exact.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bounds.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 256;       // rows per tile == threads per block
constexpr int kWarps = kTile / 32;
constexpr int kMaxBlocks = 8;    // the portable cluster size
// shared memory per destination: its word of per-warp bytes and base
constexpr int kSmemPerDest = 8 + 4;
constexpr int kSmemDefault = 48 * 1024;

// Sum of the bytes of w, given at most 7 x 32 in its low seven bytes (the
// top byte is added apart: a whole tile on one destination sums to 256).
__device__ __forceinline__ int byte_sum(unsigned long long w) {
  const unsigned long long lo = w & 0x00FFFFFFFFFFFFFFull;
  return (int)((lo * 0x0101010101010101ull) >> 56) + (int)(w >> 56);
}

// Span: a pointer, or with its extent in the bounds-checking build
// (bounds.cuh).
using CI = xlb::Span<const int>;
using I32 = xlb::Span<int>;

__global__ void __launch_bounds__(kTile)
relay_kernel(CI XLB_RESTRICT idx, int N, int n_dest, I32 XLB_RESTRICT slot,
             I32 XLB_RESTRICT load) {
  extern __shared__ unsigned long long smem_words[];
  XLB_SMEM(0, (long long)kSmemPerDest * n_dest);
  // (n_dest,) per-warp group sizes, a byte per warp; (n_dest,) bases
  const xlb::Span<unsigned long long> words = XLB_SPAN(smem_words, n_dest);
  const I32 base = XLB_SPAN(reinterpret_cast<int*>(smem_words + n_dest),
                            n_dest);
  const xlb::Span<unsigned char> bytes = XLB_SPAN(
      reinterpret_cast<unsigned char*>(smem_words), 8LL * n_dest);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int nblk = gridDim.x, b = blockIdx.x;
  const int ntiles = (N + kTile - 1) / kTile;
  const int t0 = (int)((long long)b * ntiles / nblk);
  const int t1 = (int)((long long)(b + 1) * ntiles / nblk);
  const unsigned lt = (1u << lane) - 1;
  const unsigned long long below = (1ull << (8 * w)) - 1;  // warps < w

  int r = t0 * kTile + tid;
  int d = r < N ? idx[r] : -1;            // in flight while the table clears
  for (int k = lane; k < n_dest; k += 32) bytes[8 * k + w] = 0;  // own byte
  for (int k = tid; k < n_dest; k += kTile) base[k] = 0;
  __syncwarp();

  for (int t = t0; t < t1; ++t) {
    const int rn = r + kTile;
    const int dn = (t + 1 < t1 && rn < N) ? idx[rn] : -1;
    const bool live = d >= 0 && d < n_dest;
    const unsigned peers = __match_any_sync(~0u, live ? d : -1);
    const bool leader = live && lane == __ffs(peers) - 1;
    if (leader) bytes[8 * d + w] = (unsigned char)__popc(peers);
    __syncthreads();                       // A: every warp's byte is in
    bool first = false;
    int total = 0;
    if (live) {
      const unsigned long long word = words[d];
      const int before = byte_sum(word & below);
      slot[r] = base[d] + before + __popc(peers & lt);
      first = leader && before == 0;       // the lowest warp holding d
      total = byte_sum(word);
    } else if (r < N) {
      slot[r] = 0;
    }
    if (nblk == 1 && t + 1 == t1) {        // one tile: load is its totals
      for (int k = tid; k < n_dest; k += kTile)
        load[k] = base[k] + byte_sum(words[k]);
      return;
    }
    __syncthreads();                       // B: every read of the tile done
    if (first) base[d] += total;
    if (leader) bytes[8 * d + w] = 0;
    __syncwarp();
    r = rn;
    d = dn;
  }

  // Many blocks: base[] holds this block's totals.  Read the other
  // blocks' through distributed shared memory.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                          // every block's totals are in
  const I32 pre = XLB_SPAN(reinterpret_cast<int*>(smem_words),
                           2LL * n_dest);     // the bytes are free now
  for (int k = tid; k < n_dest; k += kTile) {
    int lower = 0, all = 0;
    for (int j = 0; j < nblk; ++j) {
      const int v =
          *cluster.map_shared_rank(xlb::raw(base) + XLB_IX(k, n_dest), j);
      lower += j < b ? v : 0;
      all += v;
    }
    pre[k] = lower;
    if (b == nblk - 1) load[k] = all;
  }
  cluster.sync();                          // no block reads another's now
  if (b == 0) return;
  for (int rr = t0 * kTile + tid; rr < min(N, t1 * kTile); rr += kTile) {
    const int dd = idx[rr];
    if (dd >= 0 && dd < n_dest) slot[rr] += pre[dd];
  }
}

}  // namespace

extern "C" int xlb_relay(const int* idx, int N, int n_dest, int* slot,
                         int* load, void* stream) {
  const size_t smem = (size_t)kSmemPerDest * n_dest;
  if (N <= 0 || n_dest < 0 || smem > kSmemDefault)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = (N + kTile - 1) / kTile;
  const int nblk = ntiles < kMaxBlocks ? ntiles : kMaxBlocks;
  if (nblk == 1) {
    relay_kernel<<<1, kTile, smem, st>>>(XLB_SPAN(idx, N), N, n_dest,
                                         XLB_SPAN(slot, N),
                                         XLB_SPAN(load, n_dest));
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblk);
  cfg.blockDim = dim3(kTile);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = nblk;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, relay_kernel, XLB_SPAN(idx, N), N, n_dest, XLB_SPAN(slot, N),
      XLB_SPAN(load, n_dest));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
