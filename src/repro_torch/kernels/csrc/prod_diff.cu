// Log-space eigenvalue-difference sums, the EEI numerator table, for Hopper
// (sm_90a):
//     out[b, i, j] = sum_{k < K} log(max(|lam[b, i] - mu[b, j, k]|, floor[b]))
//
// Two entry points share one block body:
//   logabs_sum         replaces `logabs_sum_batched_padded` /
//                      `_logabs_sum_batched_kernel` of
//                      src/repro/kernels/prod_diff/kernel.py with its mask of
//                      all valid cells: the kernel does not visit padded
//                      cells, so it takes no mask operand.
//   logabs_sum_masked  replaces `logabs_sum_batched_masked_padded` /
//                      `_logabs_sum_batched_masked_kernel`: each matrix has
//                      its own validity mask mask[b, j, k] (one byte a
//                      cell), and a masked cell adds exactly log 1 = 0.
// `logabs_sum_padded` / `_logabs_sum_kernel` (one matrix, one scalar floor)
// is `logabs_sum` on a batch of one: its wrapper, `logabs_sum_single` in
// kernels/prod_diff/kernel.py, launches that entry with B = 1.
//
// Design: one thread per output (b, i, j).  A block of 32 x 8 threads covers
// 32 consecutive j (one warp) by 8 consecutive i of one matrix b; the grid is
// (ceil(J / 32), ceil(I / 8), B).  The block stages mu[b, j-tile, k-chunk]
// (32 x 32 values, and the mask bytes of the same cells) in shared memory
// with loads that run along k, so each warp reads consecutive addresses.
// Each thread adds its terms in order k = 0 .. K-1: no split-K and no
// atomics, so a row's sum does not depend on how many rows I the launch
// covers (the windowed rows equal the matching rows of the full table,
// bitwise), and a masked launch equals the unmasked one over the same valid
// cells in order.
//
// Bound on an H100 SXM: operations.  Each term is a subtract, an abs, a max,
// a log and an add; the accurate log (no --use_fast_math, no __logf) is a
// multi-instruction sequence.  The main path's launch is 16 x 600 x 600 x 599
// = 3.45e9 terms, bound at 0.51 ms against the 34 TFLOP/s FP64 peak (0.26 ms
// in float32 at 67 TFLOP/s), while the bytes moved, about 46 MB in and 46 MB
// out in float64, take 0.03 ms at 3.35 TB/s.  Left for later: reuse of each
// staged mu value by more i rows per thread, TMA staging of the mu tiles and
// a persistent grid.

#include <cuda_runtime.h>

namespace {

constexpr int kTileJ = 32;
constexpr int kTileI = 8;
constexpr int kChunkK = 32;

// The sums of one block, on one matrix: lam (I), mu (J, K), mask (J, K) or
// unused, out (I, J).
template <typename T, bool kMasked>
__device__ __forceinline__ void logabs_sum_block(
    const T* __restrict__ lam, const T* __restrict__ mu,
    const unsigned char* __restrict__ mask, const T fl, T* __restrict__ out,
    int I, int J, int K) {
  __shared__ T smu[kTileJ][kChunkK + 1];
  __shared__ unsigned char smask[kMasked ? kTileJ : 1][kChunkK + 1];
  const int j0 = blockIdx.x * kTileJ;
  const int i = blockIdx.y * kTileI + threadIdx.y;
  const int j = j0 + threadIdx.x;
  const int tid = threadIdx.y * kTileJ + threadIdx.x;
  const T li = i < I ? lam[i] : T(0);

  T acc = T(0);
  for (int k0 = 0; k0 < K; k0 += kChunkK) {
    const int kc = min(kChunkK, K - k0);
    for (int idx = tid; idx < kTileJ * kChunkK; idx += kTileJ * kTileI) {
      const int jj = idx / kChunkK;
      const int kk = idx % kChunkK;
      const bool in = j0 + jj < J && kk < kc;
      const size_t at = static_cast<size_t>(j0 + jj) * K + k0 + kk;
      smu[jj][kk] = in ? mu[at] : T(0);
      if constexpr (kMasked) smask[jj][kk] = in ? mask[at] : 0;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      if constexpr (kMasked) {
        acc += smask[threadIdx.x][kk]
                   ? log(fmax(fabs(li - smu[threadIdx.x][kk]), fl))
                   : T(0);
      } else {
        acc += log(fmax(fabs(li - smu[threadIdx.x][kk]), fl));
      }
    }
    __syncthreads();
  }
  if (i < I && j < J) out[static_cast<size_t>(i) * J + j] = acc;
}

template <typename T>
__global__ void logabs_sum_kernel(const T* __restrict__ lam,
                                  const T* __restrict__ mu,
                                  const T* __restrict__ floor_,
                                  T* __restrict__ out, int I, int J, int K) {
  const size_t b = blockIdx.z;
  logabs_sum_block<T, false>(lam + b * I, mu + b * J * K, nullptr, floor_[b],
                             out + b * I * J, I, J, K);
}

template <typename T>
__global__ void logabs_sum_masked_kernel(const T* __restrict__ lam,
                                         const T* __restrict__ mu,
                                         const unsigned char* __restrict__ mask,
                                         const T* __restrict__ floor_,
                                         T* __restrict__ out, int I, int J,
                                         int K) {
  const size_t b = blockIdx.z;
  logabs_sum_block<T, true>(lam + b * I, mu + b * J * K, mask + b * J * K,
                            floor_[b], out + b * I * J, I, J, K);
}

dim3 grid_of(int B, int I, int J) {
  return dim3((J + kTileJ - 1) / kTileJ, (I + kTileI - 1) / kTileI, B);
}

template <typename T>
int launch_logabs_sum(const T* lam, const T* mu, const T* floor_, T* out,
                      int B, int I, int J, int K, void* stream) {
  logabs_sum_kernel<T><<<grid_of(B, I, J), dim3(kTileJ, kTileI), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      lam, mu, floor_, out, I, J, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_logabs_sum_masked(const T* lam, const T* mu,
                             const unsigned char* mask, const T* floor_,
                             T* out, int B, int I, int J, int K,
                             void* stream) {
  logabs_sum_masked_kernel<T><<<grid_of(B, I, J), dim3(kTileJ, kTileI), 0,
                                static_cast<cudaStream_t>(stream)>>>(
      lam, mu, mask, floor_, out, I, J, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int logabs_sum_f32(const float* lam, const float* mu,
                              const float* floor_, float* out, int B, int I,
                              int J, int K, void* stream) {
  return launch_logabs_sum<float>(lam, mu, floor_, out, B, I, J, K, stream);
}

extern "C" int logabs_sum_f64(const double* lam, const double* mu,
                              const double* floor_, double* out, int B, int I,
                              int J, int K, void* stream) {
  return launch_logabs_sum<double>(lam, mu, floor_, out, B, I, J, K, stream);
}

extern "C" int logabs_sum_masked_f32(const float* lam, const float* mu,
                                     const unsigned char* mask,
                                     const float* floor_, float* out, int B,
                                     int I, int J, int K, void* stream) {
  return launch_logabs_sum_masked<float>(lam, mu, mask, floor_, out, B, I, J,
                                         K, stream);
}

extern "C" int logabs_sum_masked_f64(const double* lam, const double* mu,
                                     const unsigned char* mask,
                                     const double* floor_, double* out, int B,
                                     int I, int J, int K, void* stream) {
  return launch_logabs_sum_masked<double>(lam, mu, mask, floor_, out, B, I,
                                          J, K, stream);
}
