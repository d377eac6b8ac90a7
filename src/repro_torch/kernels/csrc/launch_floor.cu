// The launch floor of the card: no datapath kernel of one launch can take
// less device time than an empty kernel does.  `xlb_empty_launches` issues
// n empty one-thread kernels back to back on one stream from a C loop, so
// timing the batch with CUDA events and dividing by n gives the device
// time per launch with no Python in between.  Used only to state the
// kernels' bounds; no datapath code calls it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int xlb_empty_launches(int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) empty_kernel<<<1, 1, 0, st>>>();
  return (int)cudaGetLastError();
}
