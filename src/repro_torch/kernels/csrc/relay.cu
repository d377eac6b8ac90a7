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
// What bounds it: the sequential dependence of a row's rank on every
// earlier row, not bytes: the staged chain's batches move a few KB.
//
// Design: the TPU kernel walks tiles in order and carries the
// per-destination base in VMEM; Hopper blocks run in no order, so ONE
// block loops over tiles of kTile rows, one thread per row, with
// counts[n_dest] in shared memory.  Each row's rank is the tile-start
// count of its destination plus the same-destination rows before it in
// the tile (a scan of the tile, staged in shared memory).  After a
// barrier every live row adds one to its destination with an integer
// shared atomic - order-free, so the result is bit-exact.  A single block
// is slow by design at large N; a multi-block scan is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;       // rows per tile == threads per block

__global__ void __launch_bounds__(kTile)
relay_kernel(const int* __restrict__ idx, int N, int n_dest,
             int* __restrict__ slot, int* __restrict__ load) {
  extern __shared__ int smem[];
  int* counts = smem;            // (n_dest,) running per-destination count
  int* tile = smem + n_dest;     // (kTile,) this tile's destinations
  const int tid = threadIdx.x;
  for (int k = tid; k < n_dest; k += kTile) counts[k] = 0;
  __syncthreads();

  for (int base = 0; base < N; base += kTile) {
    const int r = base + tid;
    const int d = r < N ? idx[r] : -1;
    const bool live = d >= 0 && d < n_dest;
    tile[tid] = live ? d : -1;
    __syncthreads();             // the tile is staged; counts are settled
    if (live) {
      int rank = counts[d];
#pragma unroll 8
      for (int j = 0; j < tid; ++j) rank += tile[j] == d;
      slot[r] = rank;
    } else if (r < N) {
      slot[r] = 0;
    }
    __syncthreads();             // every read of counts and tile is done
    if (live) atomicAdd(&counts[d], 1);
  }
  __syncthreads();
  for (int k = tid; k < n_dest; k += kTile) load[k] = counts[k];
}

}  // namespace

extern "C" int xlb_relay_smem_bytes(int n_dest) {
  return 4 * (n_dest + kTile);
}

extern "C" int xlb_relay(const int* idx, int N, int n_dest, int* slot,
                         int* load, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  relay_kernel<<<1, kTile, xlb_relay_smem_bytes(n_dest), st>>>(
      idx, N, n_dest, slot, load);
  return (int)cudaGetLastError();
}
