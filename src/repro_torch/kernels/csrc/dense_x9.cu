// The decode's float32 matrix products y = x @ W on the tensor cores, as
// nine exact bf16 products.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA
// (plain jnp `x @ W` in repro/models/layers.py, attention.py and model.py).
// On the card the same products went to cuBLAS's SGEMM, an sm80 kernel on
// the CUDA cores at their 67 TFLOP/s f32 peak, while the tensor cores stood
// idle; TF32 would keep only about three decimal digits.  This kernel is
// added so that the float32 decode (M <= 256 rows, the batch of lanes) runs
// on the tensor cores without giving up float32's precision.
//
// The arithmetic.  Each f32 value v splits into three bf16 values whose sum
// is v exactly: hi = bf16(v), mid = bf16(v - hi), lo = v - hi - mid (a
// 24-bit significand is three 8-bit pieces; each residual is exact in f32
// and the last fits bf16 while it stays in bf16's normal range).  The
// product of two bf16 values is exact in f32, so the nine products of x's
// planes with W's planes sum to x . W exactly, and the only rounding left
// is the f32 accumulation.  W's planes are made once, before the serving
// tick is captured (kernels/dense_x9.py), as a (3, K, N) bf16 tensor laid
// out like W; x is split here, in registers.  The tensor cores' f32
// accumulation is not IEEE round to nearest (it aligns to the largest
// addend and drops the bits below), so the partial sums stay short: each
// warpgroup's wgmma accumulator holds one 32-deep stage (two k16 steps),
// the small cross products first and hi x hi last, and is then added into
// an f32 register sum with ordinary (round-to-nearest) adds.
//
// What bounds it on this card, at the Minitron-4B gateway's decode (128
// rows, 3.41 B weights a tick: 32 layers of wq, wk, wv, wo, w_in, w_out
// and the 3072 x 256000 head): operations.  Nine bf16 products are 7.86
// TFLOP a tick, 7.95 ms at the 989 TFLOP/s dense peak; the planes are 20.5
// GB, 6.1 ms at 3.35 TB/s.  At 128 rows a weight byte is used for 384
// operations, above the card's 295, so the tensor cores, not the memory,
// are the limit, by little.
//
// The design.  A persistent grid of one block an SM walks a flattened
// (tile, stage) space: tiles of 128 rows x 128 columns of y, each
// ceil(K / 32) stages deep; block c takes stages [c W / G, (c + 1) W / G),
// so every block does the same work whatever the shape (the decode's
// shapes have 8 to 2000 column tiles).  A producer warp keeps a five-stage
// ring full with TMA: per stage x's (128 rows x 32) f32 box and W's three
// (32 x 128) plane tiles, 40 KB, in the 128-byte swizzle that the wgmma
// descriptors read (W's tiles through the transpose bit: W is stored K x N
// as the model holds it).  Two consumer warpgroups own 64 rows each: a
// thread reads its A fragments of the stage from shared memory, splits them
// into three bf16 register fragments, and issues the stage's 18 wgmmas
// (nine products x two k16 steps) with A from registers.  Named barriers
// hand the turn to issue between the two warpgroups, so one's adds, its
// split of the next stage and its stores run while the other's products
// keep the tensor cores busy.  (A thread that split the next stage into
// other registers while its own wgmmas still read the current ones got
// wrong sums on the card; the turns leave nothing to gain from it.)  A
// block's range starts and ends inside tiles: a tile it covers whole goes
// straight to y; the part
// of a tile it covers goes to one of its two slots of a workspace, and a
// second kernel sums each split tile's parts in the order of K (no
// atomics: two calls are bitwise equal).  The kernels run on PyTorch's
// current stream and allocate nothing; the wrapper hands in y and the
// workspace, so a call is captured into a CUDA graph as it is.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "bounds.cuh"
#include "float_io.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBM = 128;                   // rows of a tile
constexpr int kBN = 128;                   // columns of a tile
constexpr int kBK = 32;                    // depth of a stage
constexpr int kStages = 5;                 // the ring
constexpr int kConsumers = 256;            // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kXBytes = kBM * kBK * 4;     // x's box: 128 rows of 128 B
constexpr int kPanel = kBK * 128;          // 32 rows of 64 bf16 columns
constexpr int kPlane = 2 * kPanel;         // a plane's 128 columns
constexpr int kStage = kXBytes + 3 * kPlane;  // 40 KB
constexpr int kRing = kStages * kStage;
// mbarriers after the ring: full and empty per stage
constexpr int kSmem = 1024 + kRing + 16 * kStages;
constexpr int kReduceRows = 8;             // rows a reduce block sums

struct Args {
  float* y;                 // (M, N)
  float* ws;                // (2 G, kBM, kBN): two slots a block
  int M, K, N;
  int ks;                   // stages a tile
  int n_tiles;              // column tiles
  long long work;           // tiles x ks
  int grid;                 // G
#ifdef XLB_BOUNDS_CHECK
  long long ny, nws;        // extents in elements
#endif
};

__host__ __device__ __forceinline__ long long start_of(const Args& a,
                                                       int c) {
  return a.work * c / a.grid;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) as three bf16 pairs whose sums are v0 and v1 exactly.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float r0 = v0 - __low2float(h), r1 = v1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - __low2float(m),
                                  r1 - __high2float(m)));
}

// A fragments of one stage: [plane][k16 step][register].
using Frag = uint32_t[3][2][4];

// The thread's A fragments of the stage at `xs` (x's swizzled box), split
// into planes.  Register r of step kk holds row `row` (+ 8 for odd r),
// columns 16 kk + 8 (r / 2) + 2 t and + 1; the 16-byte chunk c of a row
// sits at chunk c ^ (row % 8).
__device__ __forceinline__ void load_a(Frag& f, const unsigned char* xs,
                                       int row, int t) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int rr = row + 8 * (r & 1), col = 16 * kk + 8 * (r >> 1) + 2 * t;
      const float2 v = *reinterpret_cast<const float2*>(
          xs + rr * 128 + ((((col >> 2) ^ (rr & 7)) << 4) | ((col & 3) * 4)));
      split3(v.x, v.y, f[0][kk][r], f[1][kk][r], f[2][kk][r]);
    }
}

// The stage's 18 wgmmas into acc (overwritten by the first): the nine
// (x plane, W plane) products, the smallest first, hi x hi last, each over
// both k16 steps.
__device__ __forceinline__ void products(float (&acc)[64], const Frag& f,
                                         uint32_t ws) {
  constexpr int kA[9] = {2, 2, 1, 2, 1, 0, 1, 0, 0};
  constexpr int kB[9] = {2, 1, 2, 0, 1, 2, 0, 1, 0};
#pragma unroll
  for (int q = 0; q < 9; ++q)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      xlb::wgmma_rs_tb(acc, f[kA[q]][kk],
                       xlb::wgmma_desc(ws + kB[q] * kPlane + kk * 16 * 128,
                                       kPanel, 8 * 128, 128),
                       q + kk > 0);
}

__global__ void __launch_bounds__(kThreads, 1)
    dense_x9_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w, Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (xlb::smem_u32(smem_raw) + 1023) & ~1023u;
  const unsigned char* ring_p = smem_raw + (ring - xlb::smem_u32(smem_raw));
  const uint32_t full = ring + kRing, empty = full + 8 * kStages;
  const int tid = threadIdx.x, c = blockIdx.x;
  const long long s0 = start_of(a, c);
  const int n = (int)(start_of(a, c + 1) - s0);   // stages of this block

  XLB_SMEM(empty + 8 * kStages - xlb::smem_u32(smem_raw) - 1, 1);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      xlb::mbar_init(full + 8 * s, 1);
      xlb::mbar_init(empty + 8 * s, kConsumers);
    }
    xlb::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {                  // the producer
    xlb::regs_dec<40>();
    if (tid == kConsumers) {
      for (int j = 0; j < n; ++j) {
        const long long i = s0 + j;
        const int t = (int)(i / a.ks), k = (int)(i % a.ks);
        const int mb = t / a.n_tiles, nt = t % a.n_tiles;
        const int s = j % kStages;
        xlb::mbar_wait(empty + 8 * s, ((j / kStages) & 1) ^ 1);
        const uint32_t st = ring + s * kStage, bar = full + 8 * s;
        xlb::mbar_expect_tx(bar, kStage);
        xlb::tma_load_4d(st, &tm_x, bar, k * kBK, mb * kBM, 0, 0);
        for (int p = 0; p < 3; ++p)
          for (int h = 0; h < 2; ++h)
            xlb::tma_load_4d(st + kXBytes + p * kPlane + h * kPanel, &tm_w,
                             bar, nt * kBN + 64 * h, k * kBK, p, 0);
      }
    }
    return;
  }

  // The consumers.  Warpgroup w issues its wgmmas only in its turn (named
  // barrier 1 + w, opened by the other once it has issued its own);
  // warpgroup 0 goes first.
  xlb::regs_inc<232>();
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int t4 = lane % 4;
  const int row = wg * 64 + warp * 16 + lane / 4;  // and row + 8, in a tile
  const int my_turn = 1 + wg, other_turn = 2 - wg;
  float sum[64], acc[64];
  Frag f;
#pragma unroll
  for (int q = 0; q < 64; ++q) sum[q] = acc[q] = 0.f;
  if (wg == 1) xlb::bar_arrive(1, kConsumers);

  long long seg = s0;                       // the first stage of the segment
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const int s = j % kStages;
    const long long i = s0 + j;
    xlb::mbar_wait(full + 8 * s, (j / kStages) & 1);
    load_a(f, ring_p + s * kStage, row, t4);
    xlb::bar_sync(my_turn, kConsumers);
    xlb::wgmma_fence();
    products(acc, f, ring + s * kStage + kXBytes);
    xlb::wgmma_commit();
    if (wg == 0 || j + 1 < n) xlb::bar_arrive(other_turn, kConsumers);
    xlb::wgmma_wait<0>();
    xlb::reg_fence(acc);
#pragma unroll
    for (int p = 0; p < 3; ++p) xlb::reg_fence(f[p]);
    xlb::mbar_arrive(empty + 8 * s);
#pragma unroll
    for (int q = 0; q < 64; ++q) sum[q] += acc[q];

    if ((i + 1) % a.ks != 0 && j + 1 < n) continue;   // the segment goes on
    // the segment [seg, i] of tile t ends: y where it is the whole tile,
    // else this block's slot (its first segment, or its last)
    const int t = (int)(i / a.ks);
    const int mb = t / a.n_tiles, nt = t % a.n_tiles;
    const int rows = min(kBM, a.M - mb * kBM), cols = min(kBN, a.N - nt * kBN);
    const bool whole = seg % a.ks == 0 && (i + 1) % a.ks == 0;
    float* dst;
    long long ld, base;
    if (whole) {
      base = (long long)mb * kBM * a.N + (long long)nt * kBN;
      ld = a.N;
      dst = a.y + base;
    } else {
      base = (long long)(2 * c + (seg == s0 ? 0 : 1)) * kBM * kBN;
      ld = kBN;
      dst = a.ws + base;
    }
#pragma unroll
    for (int q = 0; q < 64; q += 2) {
      const int rr = row + 8 * ((q >> 1) & 1), col = 8 * (q / 4) + 2 * t4;
      if (rr < rows && col < cols) {
        XLB_CHECK(base + rr * ld + col + 1, whole ? a.ny : a.nws);
        *reinterpret_cast<float2*>(dst + rr * ld + col) =
            make_float2(sum[q], sum[q + 1]);
      }
      sum[q] = sum[q + 1] = 0.f;
    }
    seg = i + 1;
  }
}

// Each tile split between blocks: its parts summed in the order of K.
// Block x handles the boundary between blocks x and x + 1 where it falls
// inside a tile and the boundary before it does not fall inside the same
// tile; block y its rows [8 y, 8 y + 8), a float4 of a row a thread.  The
// tile is the last segment of the block before the boundary (its first,
// where that block starts on the tile's first stage) and the first
// segment of each block after it that starts inside the tile.
__global__ void __launch_bounds__(256) dense_x9_reduce(Args a) {
  const int c = blockIdx.x + 1;
  const long long b = start_of(a, c);
  if (b % a.ks == 0) return;                 // no tile is split here
  const long long t = b / a.ks, t0 = t * a.ks, t1 = t0 + a.ks;
  const long long before = start_of(a, c - 1);
  if (c > 1 && before > t0) return;          // the earlier boundary's
  // the last block that starts before t1: start_of(k) < t1 <=> k W < t1 G
  const int last = (int)min((long long)a.grid - 1, (t1 * a.grid - 1) / a.work);
  const int mb = (int)(t / a.n_tiles), nt = (int)(t % a.n_tiles);
  const int rows = min(kBM, a.M - mb * kBM), cols = min(kBN, a.N - nt * kBN);
  const int r = blockIdx.y * kReduceRows + threadIdx.x / (kBN / 4);
  const int col = 4 * (threadIdx.x % (kBN / 4));
  if (r >= rows || col >= cols) return;
  const long long tile = (long long)kBM * kBN, at = r * kBN + col;
  long long off = (2LL * (c - 1) + (before >= t0 ? 0 : 1)) * tile + at;
  XLB_CHECK(off + 3, a.nws);
  float4 s = *reinterpret_cast<const float4*>(a.ws + off);
#pragma unroll 4
  for (int k = c; k <= last; ++k) {
    off = 2LL * k * tile + at;
    XLB_CHECK(off + 3, a.nws);
    const float4 v = *reinterpret_cast<const float4*>(a.ws + off);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const long long o = (long long)(mb * kBM + r) * a.N + nt * kBN + col;
  XLB_CHECK(o + 3, a.ny);
  *reinterpret_cast<float4*>(a.y + o) = s;
}

// A 4-D tiled map over `base` with the given dims (elements), byte strides
// of dims 1..3, box and element type; 128-byte swizzle, zeros past the
// edges.
int encode(CUtensorMap* map, const void* base, CUtensorMapDataType type,
           const cuuint64_t (&dims)[4], const cuuint64_t (&strides)[3],
           const cuuint32_t (&box)[4]) {
  xlb::EncodeTiled fn = xlb::tensor_map_encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = fn(map, type, 4, const_cast<void*>(base), dims, strides, box,
                  unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// y (M, N) f32 = x (M, K) f32, contiguous, @ the weight whose bf16 planes
// (3, K, N), contiguous, are `planes`; `ws` holds 2 * grid * 128 * 128
// floats; grid <= the tiles x stages of the call.  K % 4 == 0 and N % 8 ==
// 0 (TMA's 16-byte strides), 16-byte aligned bases.
extern "C" int xlb_dense_x9(const void* x, const void* planes, void* y,
                            void* ws, int M, int K, int N, int grid,
                            void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 4 || N % 8 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<float*>(y), static_cast<float*>(ws), M, K, N,
         (K + kBK - 1) / kBK, (N + kBN - 1) / kBN, 0, grid};
  a.work = (long long)((M + kBM - 1) / kBM) * a.n_tiles * a.ks;
  if (grid > a.work) return (int)cudaErrorInvalidValue;
#ifdef XLB_BOUNDS_CHECK
  a.ny = (long long)M * N;
  a.nws = 2LL * grid * kBM * kBN;
#endif
  CUtensorMap mx, mw;
  const cuuint64_t m = M, k = K, nn = N;
  int err = encode(&mx, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, {k, m, 1, 1},
                   {k * 4, k * m * 4, k * m * 4}, {kBK, kBM, 1, 1});
  if (!err)
    err = encode(&mw, planes, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 {nn, k, 3, 1}, {nn * 2, k * nn * 2, 3 * k * nn * 2},
                 {64, kBK, 1, 1});
  if (err) return err;
  cudaError_t e = xlb::allow_smem(dense_x9_kernel, kSmem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dense_x9_kernel<<<grid, kThreads, kSmem, st>>>(mx, mw, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bool split = false;
  for (int c = 1; c < grid && !split; ++c) split = start_of(a, c) % a.ks != 0;
  if (split) {
    dense_x9_reduce<<<dim3(grid - 1, kBM / kReduceRows), 256, 0, st>>>(a);
    e = cudaGetLastError();
  }
  return (int)e;
}
