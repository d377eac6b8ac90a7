// The bounds-checking build of the kernels (-DXLB_BOUNDS_CHECK).
//
// Built with the flag, every computed index of global and shared memory
// that goes through these helpers is checked on the device: an index
// outside [0, n) prints the array's site, the index and n, and traps, so
// the launch fails with an error that the wrapper raises.  Without the
// flag the helpers are the bare index and the bare pointer: the normal
// build's code does not change.
//
//   XLB_IX(i, n)   the index i (as a long long), checked against [0, n)
//   XLB_CHECK(i, n)  the same check as a statement
//   Span<T>        a pointer that carries its extent n in the checking
//                  build (T* otherwise); [] checks, + narrows the extent
//   XLB_SPAN(p, n) a Span over p[0, n)
//   XLB_SMEM(off, bytes)  a dynamic shared-memory byte range [off, off +
//                  bytes) checked against the launch's dynamic size
//   XLB_RESTRICT   __restrict__ on a kernel's pointer parameter (nothing
//                  on a Span)
//   XLB_ARG(x)     x in the checking build, 0 otherwise (an extent handed
//                  to a helper that checks against it)
//
// The sanitizer's memcheck does the same without a rebuild where it can
// attach to the card; this build is the check where it cannot.

#pragma once

#ifdef XLB_BOUNDS_CHECK
#include <cstdio>
#endif

namespace xlb {

#ifdef XLB_BOUNDS_CHECK

static __device__ __noinline__ void bounds_fail(long long i, long long n,
                                                const char* file, int line) {
  printf("XLB_BOUNDS_CHECK: index %lld outside [0, %lld) at %s:%d "
         "(block %d %d %d, thread %d)\n",
         i, n, file, line, blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x);
  __trap();
}

__device__ __forceinline__ long long checked(long long i, long long n,
                                             const char* file, int line) {
  if (i < 0 || i >= n) bounds_fail(i, n, file, line);
  return i;
}

__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned n;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(n));
  return n;
}

#define XLB_IX(i, n) \
  ::xlb::checked((long long)(i), (long long)(n), __FILE__, __LINE__)
#define XLB_CHECK(i, n) \
  ((void)::xlb::checked((long long)(i), (long long)(n), __FILE__, __LINE__))
#define XLB_SMEM(off, bytes)                                          \
  (void)::xlb::checked((long long)(off) + (long long)(bytes) - 1,     \
                       (long long)::xlb::dynamic_smem_bytes() +       \
                           ((bytes) == 0),                            \
                       __FILE__, __LINE__)

// line: the source line the Span was made at (host or device), printed
// on a failure.  Pointer arithmetic is not an access: + narrows the extent
// unchecked (a row past the batch may form its pointer), and [] checks.
template <typename T>
struct Span {
  T* p;
  long long n;
  int line;
  __host__ __device__ Span() : p(nullptr), n(0), line(0) {}
  __host__ __device__ Span(T* p_, long long n_, int line_)
      : p(p_), n(n_), line(line_) {}
  // a non-const Span converts to a const one
  template <typename U>
  __host__ __device__ Span(const Span<U>& s) : p(s.p), n(s.n), line(s.line) {}
  __device__ __forceinline__ T& operator[](long long i) const {
    return p[checked(i, n, "the span made at the line", line)];
  }
  __device__ __forceinline__ Span operator+(long long k) const {
    return Span(p + k, n - k, line);
  }
};

template <typename T>
__host__ __device__ inline Span<T> span(T* p, long long n, int line) {
  return Span<T>(p, n, line);
}

#define XLB_SPAN(p, n) ::xlb::span((p), (long long)(n), __LINE__)
// __restrict__ applies to pointers, not to a Span
#define XLB_RESTRICT
#define XLB_ARG(x) (x)

#else

template <typename T>
using Span = T*;

#define XLB_IX(i, n) (i)
#define XLB_CHECK(i, n) ((void)0)
#define XLB_ARG(x) 0
#define XLB_SMEM(off, bytes) ((void)0)
#define XLB_SPAN(p, n) (p)
#define XLB_RESTRICT __restrict__

#endif

// The raw pointer of a Span (itself in the normal build).
template <typename T>
__host__ __device__ __forceinline__ T* raw(T* p) {
  return p;
}
#ifdef XLB_BOUNDS_CHECK
template <typename T>
__host__ __device__ __forceinline__ T* raw(const Span<T>& s) {
  return s.p;
}
#endif

}  // namespace xlb
