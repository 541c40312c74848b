// Sturm-sequence bisection eigenvalues of a stack of symmetric tridiagonal
// bands, for Hopper (sm_90a).
//
// Replaces the TPU kernel `sturm_padded` / `_sturm_kernel` of
// src/repro/kernels/sturm/kernel.py.  Lane (row, m) bisects n_iter times for
// eigenvalue index target_base + m of band `row`; each bisection runs the
// Sturm recurrence
//     q_0 = d_0 - x,   q_k = (d_k - x) - e_{k-1}^2 / q_{k-1},
//     |q| < pivmin -> -pivmin,   count = #{k : q_k < 0}
// over exactly n steps.  count <= target moves lo up, else hi down.
//
// Design: grid (rows, ceil(m / 128)), 128 threads, one lane per thread.  The
// block stages its row's d and e^2 in shared memory (2 n values: 9.6 KB at
// n = 600 in float64); every thread reads the same address at each step, a
// broadcast.  Lanes past m load shared memory and leave.  A lane's arithmetic
// is its own, so a window of lanes (target_base > 0, m < n) is bitwise-equal
// to the same lanes of the full spectrum.  The TPU padding of the band is not
// carried over: masking the lane edge gives the same counts.
//
// Bound on an H100 SXM: operations.  Each recurrence step is a dependent
// chain of one IEEE divide, two subtracts, an abs, two compares, a select
// and an integer add; the divide is a multi-instruction sequence in both
// float64 and float32 (no --use_fast_math: an approximate divide moves
// counts at zero crossings).  The minor-spectra launch of the main path is
// 9600 rows x 599 lanes x 64 iterations x 599 steps, about 2.2e11 steps:
// at 8 operations a step against the 34 TFLOP/s FP64 peak its bound is
// 51.9 ms (13.2 ms in float32 at 32 iterations and 67 TFLOP/s); the
// full-spectrum launch (16 x 600 lanes) is bound at 0.087 ms but is only
// 80 blocks, so each lane's 38,400-step dependent chain sets its time.
// Left for later: a persistent grid, splitting lanes across warps so each
// bisection iteration's count is shared, and TMA staging for long bands.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void sturm_bisect_kernel(const T* __restrict__ d,
                                    const T* __restrict__ e,
                                    const T* __restrict__ bounds,
                                    T* __restrict__ out, int n, int m,
                                    int target_base, int n_iter) {
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
  const int target = target_base + lane;
  T lo = bounds[row * 3 + 0];
  T hi = bounds[row * 3 + 1];
  const T pivmin = bounds[row * 3 + 2];

  for (int it = 0; it < n_iter; ++it) {
    const T mid = T(0.5) * (lo + hi);
    T q = sd[0] - mid;
    if (fabs(q) < pivmin) q = -pivmin;
    int count = q < T(0);
    for (int k = 1; k < n; ++k) {
      q = (sd[k] - mid) - se2[k - 1] / q;
      if (fabs(q) < pivmin) q = -pivmin;
      count += q < T(0);
    }
    if (count <= target) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  out[row * m + lane] = T(0.5) * (lo + hi);
}

template <typename T>
int launch_sturm_bisect(const T* d, const T* e, const T* bounds, T* out,
                        int rows, int n, int m, int target_base, int n_iter,
                        void* stream) {
  constexpr int kThreads = 128;
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sturm_bisect_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(rows, (m + kThreads - 1) / kThreads);
  sturm_bisect_kernel<T><<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      d, e, bounds, out, n, m, target_base, n_iter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sturm_bisect_f32(const float* d, const float* e,
                                const float* bounds, float* out, int rows,
                                int n, int m, int target_base, int n_iter,
                                void* stream) {
  return launch_sturm_bisect<float>(d, e, bounds, out, rows, n, m,
                                    target_base, n_iter, stream);
}

extern "C" int sturm_bisect_f64(const double* d, const double* e,
                                const double* bounds, double* out, int rows,
                                int n, int m, int target_base, int n_iter,
                                void* stream) {
  return launch_sturm_bisect<double>(d, e, bounds, out, rows, n, m,
                                     target_base, n_iter, stream);
}
