// Normalized minor-determinant magnitudes |w[i, j]|^2 of a stack of
// symmetric tridiagonal bands at a window of shifts, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  `repro` computes this function,
// tridiag_windowed_magnitudes (src/repro/core/identity.py), with two
// `lax.scan`s that XLA compiles into loops on the device; the port's plain
// version (core/identity.py) is a host loop of about seven launches a band
// row, so the top-k `minor_det` stage and each Lanczos residual check
// issued thousands of launches of a few microseconds of work each.  This
// kernel computes the whole function in one launch.
//
// Lane (row, i) takes the band of `row` at the shift x = x[row, i]:
//     q_0 = d_0 - x,         q_l = (d_l - x) - e_{l-1}^2 / q_{l-1},
//     p_{n-1} = d_{n-1} - x, p_l = (d_l - x) - e_l^2 / p_{l+1},
//     |q| < pivmin -> -pivmin (and the same for p),
//     log_f[j] = sum_{l < j} log|q_l|,  log_g[j] = sum_{l > j} log|p_l|,
//     v_j = log_f[j] + log_g[j] = log|det(M_j - x I)|,
//     out[i, j] = exp(v_j - max v) / sum_j exp(v_j - max v),
// with pivmin = max(eps^2 * scale^2, tiny) and scale = max(|d|, |e|) of the
// row, as the plain version computes them.
//
// Bound on an H100: the dependent chain.  Each lane runs 2(n - 1) IEEE
// divides, each waiting for the last; the bytes (the band once, the output
// once) and the operations are trivial at the main path's shapes (2,048
// lanes of n = 128, 128 lanes of n = 256).  So the design is for latency:
//   * the forward and the backward sweep of a lane run at once, on the two
//     threads 2l and 2l + 1 of one warp.  Both run one code path (the
//     direction only moves the indices), so the warp never diverges and the
//     chain a lane waits for is n - 1 divides, not 2(n - 1);
//   * a sweep does nothing but the recurrence and stores |q|: a warp issues
//     in order, so a log inside the sweep would stand in the chain (on an
//     H100 80GB HBM3 one lane's float64 step took 218 ns with the log and
//     the prefix sum in it, 119 ns without);
//   * then every thread of the block takes the logs, all at once, and the
//     two threads of a lane add their prefix sums, in the order and the
//     precision in which PyTorch's cumsum adds on the card (sequentially
//     from the first term): a chain of adds, not of divides;
//   * the band (d and e^2) is staged once a block in shared memory, while
//     the block finds the row's scale for pivmin;
//   * the forward terms go to the output, the backward ones to a scratch of
//     the output's shape (from the wrapper); at n = 4096 a lane's 2n terms
//     would not fit shared memory beside other lanes', and both stay in L2.
//     Each warp then takes whole rows: v = log_f + log_g, the row max, exp
//     and the row sum by shuffles, then the division.
// A block takes up to `cap` lanes of one row (grid (rows, ceil(k / cap))).
// Measured on that card (PERF.md): 25 us for topk8's 256 bands of 128 at
// k = 8 and 60 us for topk16's 8 of 256 at k = 16, float64, about twice
// the chain of n - 1 steps at one lane's step time.
//
// Arithmetic: every step is the plain version's, in its order: the divide
// stays IEEE (no --use_fast_math), (d - x) - e^2 / q keeps its order, the
// clamp is the same compare and select, log, exp and the division are the
// CUDA math library's, which PyTorch's own kernels call, and the max
// propagates a NaN as torch.amax does.  Only the row sum is taken in
// another order (a sum a thread and a butterfly across the warp, against
// PyTorch's reduction), so the kernel equals the plain version on the card
// to a few units in the last place of the normalisation.
//
// It launches on the caller's stream, allocates nothing and never
// synchronises, so a CUDA graph can hold it.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 128;
// Terms of a prefix sum loaded at once.
constexpr int kChunk = 16;

template <typename T>
struct Limits;
template <>
struct Limits<float> {
  // finfo(float32).eps ** 2 and finfo(float32).tiny.
  static __device__ __forceinline__ float eps2() { return 0x1p-46f; }
  static __device__ __forceinline__ float tiny() { return 0x1p-126f; }
  static __device__ __forceinline__ float neg_inf() { return -CUDART_INF_F; }
};
template <>
struct Limits<double> {
  static __device__ __forceinline__ double eps2() { return 0x1p-104; }
  static __device__ __forceinline__ double tiny() { return 0x1p-1022; }
  static __device__ __forceinline__ double neg_inf() { return -CUDART_INF; }
};

// max(a, b) that returns a NaN operand, as torch.amax and torch.maximum do.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    minor_det_kernel(const T* __restrict__ d, const T* __restrict__ e,
                     const T* __restrict__ x, T* out, T* scratch, int n,
                     int k, int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T s_warp[kMaxThreads / 32];
  T* sd = reinterpret_cast<T*>(smem_raw);
  T* se2 = sd + n;  // se2[l] = e_{l-1}^2, l >= 1
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t row = blockIdx.x;
  const int lane0 = blockIdx.y * cap;
  const int lanes = min(cap, k - lane0);

  // Stage the band and find the row's scale.
  const T* drow = d + row * n;
  const T* erow = e + row * (n - 1);
  T scale = T(0);
  for (int l = tid; l < n; l += blockDim.x) {
    const T dl = drow[l];
    sd[l] = dl;
    scale = nan_max(scale, fabs(dl));
    if (l > 0) {
      const T el = erow[l - 1];
      se2[l] = el * el;
      scale = nan_max(scale, fabs(el));
    }
  }
  scale = warp_max(scale);
  if ((tid & 31) == 0) s_warp[warp] = scale;
  __syncthreads();
  scale = s_warp[0];
  for (int w = 1; w < nwarps; ++w) scale = nan_max(scale, s_warp[w]);
  T pivmin = Limits<T>::eps2() * scale * scale;
  if (pivmin < Limits<T>::tiny()) pivmin = Limits<T>::tiny();
  const T neg_piv = -pivmin;

  // The two sweeps: thread 2l forward into out, 2l + 1 backward into
  // scratch; |q_l| goes where log_f (log_g) takes its term.
  const size_t first = row * k + lane0;
  const int back = tid & 1;
  const int dir = back ? -1 : 1;
  const int start = back ? n - 1 : 0;
  T* sums = (back ? scratch : out) + (first + (tid >> 1)) * n;
  if (tid < 2 * lanes && n > 1) {
    const T xv = x[first + (tid >> 1)];
    int pos = start;
    T q = sd[pos] - xv;
    if (fabs(q) < pivmin) q = neg_piv;
    sums[pos + dir] = fabs(q);
#pragma unroll 4
    for (int s = 2; s < n; ++s) {
      pos += dir;
      q = (sd[pos] - xv) - se2[pos + back] / q;
      if (fabs(q) < pivmin) q = neg_piv;
      sums[pos + dir] = fabs(q);
    }
  }
  __syncthreads();

  // The logs, by the whole block: columns 1 .. n-1 of each output row and
  // 0 .. n-2 of each scratch row.
  for (int t = tid; t < lanes * n; t += blockDim.x) {
    const int r = t / n;
    const int j = t - r * n;
    const size_t at = (first + r) * n + j;
    if (j > 0) out[at] = log(out[at]);
    if (j < n - 1) scratch[at] = log(scratch[at]);
  }
  __syncthreads();

  // The prefix sums, as cumsum adds them: log_f[j] = sum_{l < j} log|q_l|
  // from j = 0 up, log_g[j] = sum_{l > j} log|p_l| from j = n - 1 down.
  // The terms come in chunks, all loads of a chunk before its adds, so a
  // chunk waits for memory once.
  if (tid < 2 * lanes) {
    sums[start] = T(0);
    T acc = T(0);
    for (int s0 = 1; s0 < n; s0 += kChunk) {
      T term[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (s0 + u < n) term[u] = sums[start + dir * (s0 + u)];
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (s0 + u < n) {
          acc += term[u];
          sums[start + dir * (s0 + u)] = acc;
        }
      }
    }
  }
  __syncthreads();

  // A warp a row: combine, normalise.
  for (int r = warp; r < lanes; r += nwarps) {
    const size_t lane = row * k + lane0 + r;
    T* o = out + lane * n;
    const T* g = scratch + lane * n;
    T vmax = Limits<T>::neg_inf();
    for (int j = tid & 31; j < n; j += 32) {
      const T v = o[j] + g[j];
      o[j] = v;
      vmax = nan_max(vmax, v);
    }
    vmax = warp_max(vmax);
    T sum = T(0);
    for (int j = tid & 31; j < n; j += 32) {
      const T w = exp(o[j] - vmax);
      o[j] = w;
      sum += w;
    }
    sum = warp_sum(sum);
    for (int j = tid & 31; j < n; j += 32) o[j] = o[j] / sum;
  }
}

template <typename T>
int launch_minor_det(const T* d, const T* e, const T* x, T* out, T* scratch,
                     int rows, int n, int k, int cap, int threads,
                     void* stream) {
  if (n < 1 || cap < 1 || threads < 32 || threads % 32 ||
      threads > kMaxThreads || 2 * cap > threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        minor_det_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(rows, (k + cap - 1) / cap);
  minor_det_kernel<T><<<grid, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      d, e, x, out, scratch, n, k, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d (rows, n), e (rows, n-1), x (rows, k); out and scratch (rows, k, n).
// cap: lanes a block, at most threads / 2; threads: a multiple of 32, at
// most 128.
extern "C" int minor_det_f32(const float* d, const float* e, const float* x,
                             float* out, float* scratch, int rows, int n,
                             int k, int cap, int threads, void* stream) {
  return launch_minor_det<float>(d, e, x, out, scratch, rows, n, k, cap,
                                 threads, stream);
}

extern "C" int minor_det_f64(const double* d, const double* e,
                             const double* x, double* out, double* scratch,
                             int rows, int n, int k, int cap, int threads,
                             void* stream) {
  return launch_minor_det<double>(d, e, x, out, scratch, rows, n, k, cap,
                                  threads, stream);
}
