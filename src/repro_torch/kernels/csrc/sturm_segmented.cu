// Segment-masked Sturm-sequence bisection on packed tridiagonal bands, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `sturm_segmented_padded` /
// `_sturm_segmented_kernel` of src/repro/kernels/sturm/kernel.py.  Lane
// (row, m) carries its own bracket lo, hi, its own pivmin, a segment
// [start, end) of band `row` and an eigenvalue index `target` of that
// segment.  Each of its n_iter bisections runs the Sturm recurrence
//     q_0 = d_0 - x,   q_k = (d_k - x) - e_{k-1}^2 / q_{k-1},
//     |q| < pivmin -> -pivmin,   count = #{k in [start, end) : q_k < 0}
// over the whole band, as the TPU kernel does: at a segment junction the
// off-diagonal is zero, so q restarts by itself and the masked count is the
// exact count of the lane's own block.  count <= target moves lo up, else
// hi down.  The same kernel serves packed requests (several segments per
// row) and warm session updates (one full-band segment per row, a bracket
// per lane).
//
// Design: the one of sturm.cu.  Grid (rows, ceil(m / 128)), 128 threads,
// one lane per thread; the block stages its row's d and e^2 in shared
// memory (2 n values: 38.4 KB at n = 2400 in float64), read as a broadcast
// at every step.  Lanes past m stage and leave: there is no padding.  The
// arithmetic is the plain version's in its order, with IEEE divides (no
// --use_fast_math), so the two agree bitwise; with one full-band segment
// and the Gershgorin bracket a lane equals the same lane of sturm.cu.
//
// Bound on an H100 SXM: operations.  What any implementation must do is
// the steps inside each lane's own segment: per step the 8 operations of
// sturm.cu plus the segment compare.  This kernel runs the recurrence over
// the whole band, so on a row packed with S equal segments it does about S
// times that work.  Left for later: looping over the lane's segment alone,
// which gives the same counts only where e[start - 1] is 0, and sharing
// each bisection step's count across the lanes of a segment.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void sturm_segmented_kernel(
    const T* __restrict__ d, const T* __restrict__ e,
    const T* __restrict__ lo_in, const T* __restrict__ hi_in,
    const T* __restrict__ piv_in, const int* __restrict__ start_in,
    const int* __restrict__ end_in, const int* __restrict__ target_in,
    T* __restrict__ out, int n, int m, int n_iter) {
  extern __shared__ unsigned char smem_raw[];
  T* sd = reinterpret_cast<T*>(smem_raw);
  T* se2 = sd + n;
  const size_t row = blockIdx.x;
  const T* drow = d + row * n;
  const T* erow = e + row * (n - 1);
  for (int k = threadIdx.x; k < n; k += blockDim.x) sd[k] = drow[k];
  for (int k = threadIdx.x; k < n - 1; k += blockDim.x) {
    const T ek = erow[k];
    se2[k] = ek * ek;
  }
  __syncthreads();

  const int lane = blockIdx.y * blockDim.x + threadIdx.x;
  if (lane >= m) return;
  const size_t idx = row * m + lane;
  T lo = lo_in[idx];
  T hi = hi_in[idx];
  const T pivmin = piv_in[idx];
  const int start = start_in[idx];
  const int end = end_in[idx];
  const int target = target_in[idx];

  for (int it = 0; it < n_iter; ++it) {
    const T mid = T(0.5) * (lo + hi);
    T q = sd[0] - mid;
    if (fabs(q) < pivmin) q = -pivmin;
    int count = (q < T(0)) && start <= 0 && 0 < end;
    for (int k = 1; k < n; ++k) {
      q = (sd[k] - mid) - se2[k - 1] / q;
      if (fabs(q) < pivmin) q = -pivmin;
      count += (q < T(0)) && start <= k && k < end;
    }
    if (count <= target) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  out[idx] = T(0.5) * (lo + hi);
}

template <typename T>
int launch_sturm_segmented(const T* d, const T* e, const T* lo, const T* hi,
                           const T* pivmin, const int* start, const int* end,
                           const int* target, T* out, int rows, int n, int m,
                           int n_iter, void* stream) {
  constexpr int kThreads = 128;
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sturm_segmented_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(rows, (m + kThreads - 1) / kThreads);
  sturm_segmented_kernel<T><<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      d, e, lo, hi, pivmin, start, end, target, out, n, m, n_iter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sturm_segmented_f32(const float* d, const float* e,
                                   const float* lo, const float* hi,
                                   const float* pivmin, const int* start,
                                   const int* end, const int* target,
                                   float* out, int rows, int n, int m,
                                   int n_iter, void* stream) {
  return launch_sturm_segmented<float>(d, e, lo, hi, pivmin, start, end,
                                       target, out, rows, n, m, n_iter,
                                       stream);
}

extern "C" int sturm_segmented_f64(const double* d, const double* e,
                                   const double* lo, const double* hi,
                                   const double* pivmin, const int* start,
                                   const int* end, const int* target,
                                   double* out, int rows, int n, int m,
                                   int n_iter, void* stream) {
  return launch_sturm_segmented<double>(d, e, lo, hi, pivmin, start, end,
                                        target, out, rows, n, m, n_iter,
                                        stream);
}
