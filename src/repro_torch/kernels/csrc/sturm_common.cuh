// Device helpers shared by the two Sturm bisection kernels, sturm.cu and
// sturm_segmented.cu: the sign test of q, the negated pivot, bitwise
// equality, the band's layout in shared memory, the fixed-point test and
// the bracket list with its midpoints.  All inline; each kernel's note says
// why the arithmetic is what it is.

#pragma once

#include <cuda_runtime.h>

namespace {

// q < 0 as an integer compare: negative numbers and -inf have bit patterns
// at or below -inf's as signed integers, NaNs of either sign above it (in
// float64, on the high word: every NaN but one with high word 0xfff00000).
__device__ __forceinline__ int negative(float q) {
  return __float_as_int(q) <= static_cast<int>(0xff800000u);
}
__device__ __forceinline__ int negative(double q) {
  return __double2hiint(q) <= static_cast<int>(0xfff00000u);
}

// -x by a flip of the sign bit, as an integer operation, so that the
// compiler keeps it with the block's uniform values instead of forming it
// with a floating-point subtract at every step.
__device__ __forceinline__ float negated(float x) {
  return __uint_as_float(__float_as_uint(x) ^ 0x80000000u);
}
__device__ __forceinline__ double negated(double x) {
  return __hiloint2double(__double2hiint(x) ^ static_cast<int>(0x80000000u),
                          __double2loint(x));
}

__device__ __forceinline__ bool same(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}
__device__ __forceinline__ bool same(double a, double b) {
  return __double_as_longlong(a) == __double_as_longlong(b);
}

// The band in shared memory: step k's d_k and e_{k-1}^2 side by side, so
// that one load brings both.
template <typename T>
struct Step {
  T d, e2;
};

// The bisection has reached a fixed point for [lo, hi] with midpoint mid.
template <typename T>
__device__ __forceinline__ bool fixed(T lo, T hi, T mid) {
  return (same(mid, lo) || same(mid, hi)) && same(T(0.5) * (mid + mid), mid);
}

// One list of brackets in shared memory.
template <typename T>
struct List {
  T* lo;
  T* hi;
  int* first;
  int* last;
};

// The midpoint of node `ev % nodes` of bracket `ev / nodes` (heap order:
// root 0, children 2v+1 and 2v+2), formed from the node's own [lo, hi] as
// bisection forms it.
template <typename T>
__device__ __forceinline__ T node_mid(const List<T>& in, int ev, int nodes) {
  const int b = ev / nodes;
  const int path = ev - b * nodes + 1;
  T lo = in.lo[b];
  T hi = in.hi[b];
  T mid = T(0.5) * (lo + hi);
  for (int s = 30 - __clz(path); s >= 0; --s) {
    if ((path >> s) & 1) {
      lo = mid;
    } else {
      hi = mid;
    }
    mid = T(0.5) * (lo + hi);
  }
  return mid;
}

template <typename T>
__device__ __forceinline__ void fill(T* __restrict__ orow, int first,
                                     int last, T value) {
  for (int t = first; t <= last; ++t) orow[t] = value;
}

}  // namespace
