// Log-space eigenvalue-difference sums, the EEI numerator table, for Hopper
// (sm_90a):
//     out[b, i, j] = sum_{k < K} log(max(|lam[b, i] - mu[b, j, k]|, floor[b]))
//
// Two entry points share one block body:
//   logabs_sum         replaces `logabs_sum_batched_padded` /
//                      `_logabs_sum_batched_kernel` of
//                      src/repro/kernels/prod_diff/kernel.py (its pallas_call
//                      at line 107) with its mask of all valid cells: the
//                      kernel does not visit padded cells, so it takes no
//                      mask operand.
//   logabs_sum_masked  replaces `logabs_sum_batched_masked_padded` /
//                      `_logabs_sum_batched_masked_kernel` (line 187): each
//                      matrix has its own validity mask mask[b, j, k] (one
//                      byte a cell), and a masked cell adds exactly 0.
// `logabs_sum_padded` / `_logabs_sum_kernel` (line 251; one matrix, one
// scalar floor) is `logabs_sum` on a batch of one: its wrapper,
// `logabs_sum_single` in kernels/prod_diff/kernel.py, launches that entry
// with B = 1.
//
// Design: one log per output cell.  A cell needs the log of a product, so
// each term x = max(|lam_i - mu_jk|, floor), a positive normal number, is
// split by bit operations into its significand in [1, 2), which multiplies
// a running product, and its exponent field, which adds into an int.  After
// every kChunkK terms (at fixed positions in k) the product is split the
// same way, so it stays in [1, 2^kChunkK) and can neither overflow nor
// underflow, whatever the scale of the terms.  At the end
//     out = log(p) + E ln2,
// with E ln2 formed from a two-part ln2 by two fused multiply-adds, so it
// adds at most an ulp of out to the error of log(p).  A masked cell
// multiplies by exactly 1.0 and adds the bias to the exponent (it splits
// 1.0), and splitting a product already in [1, 2) is the identity: so a
// matrix whose mask keeps a prefix of its k terms gets bitwise the unmasked
// kernel's sums over that prefix.  A floor that is not a positive normal
// number (never one from core/identity.py::spectral_floor, which gives
// eps * (max|lam| + 1e-30)) takes the per-term log instead, for the whole
// block.
//
// A block of 32 x 8 threads covers 32 consecutive j (one warp) by 32
// consecutive i of one matrix b: each thread keeps 4 rows i in registers and
// uses each staged mu value for all of them.  The grid is (ceil(J / 32),
// ceil(I / 32), B).  The block stages mu[b, j-tile, k-chunk] (32 x 32
// values, and the mask bytes of the same cells) in shared memory with loads
// that run along k; each thread loads its part of the next chunk into
// registers while the current one is summed.  Each cell takes its terms in order k = 0 .. K-1, with
// no split-K and no atomics, so a row's sum does not depend on how many rows
// I the launch covers (the windowed rows equal the matching rows of the
// full table, bitwise).
//
// Bound on an H100 SXM: instruction issue.  The nominal count of PERF.md's
// bound (5 operations per term, a log among them) stays the yardstick: the
// main path's launch, 16 x 600 x 600 x 599 = 3.45e9 terms, is bound at 0.51
// ms against the 34 TFLOP/s FP64 peak (0.26 ms in float32 at 67 TFLOP/s),
// while the bytes moved, about 46 MB in and 46 MB out in float64, take 0.03
// ms at 3.35 TB/s.  In the SASS of the inner loop a float64 term issues 8.83
// instructions: 3 FP64 (the subtract, the compare with the floor, the
// multiply), two selects, 3.33 integer (the exponent field out and into the
// sum, the significand) and a share of the shared load; a float32 term 5.62
// (subtract, max, multiply, 2.31 integer).  The accurate log (no
// --use_fast_math, no __logf) runs once per cell.  Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py): 1.40 ms (float64) and 0.87 ms
// (float32), against 12.30 and 3.86 ms with one log per term; every number
// is in PERF.md.

#include <cuda_runtime.h>

namespace {

constexpr int kTileJ = 32;
constexpr int kThreadsI = 8;
constexpr int kRowsI = 4;
constexpr int kTileI = kThreadsI * kRowsI;
constexpr int kChunkK = 32;

// (a & b) | c in one instruction.
__device__ __forceinline__ unsigned and_or(unsigned a, unsigned b,
                                           unsigned c) {
  unsigned r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

template <typename T>
struct Split;

template <>
struct Split<float> {
  static constexpr int kBias = 127;
  __device__ static float min_normal() { return 1.17549435082228751e-38f; }
  __device__ static float max_finite() { return 3.40282346638528860e+38f; }
  // The significand of a positive normal x; its exponent field adds to e.
  __device__ static float take(float x, int& e) {
    const unsigned b = __float_as_uint(x);
    e += static_cast<int>(b >> 23);
    return __uint_as_float(and_or(b, 0x007fffffu, 0x3f800000u));
  }
  // take(max(|d|, fl)), or take(1.0) for a masked term.
  __device__ static float term(float d, float fl, bool valid, int& e) {
    return take(valid ? fmaxf(fabsf(d), fl) : 1.0f, e);
  }
  // log(p) + e ln2, with ln2 = 0x3f317218 + 0xb102e308.
  __device__ static float finish(float p, int e) {
    const float fe = static_cast<float>(e);
    return fmaf(fe, 0.693147182464599609375f,
                fmaf(fe, -1.9046542121259336e-09f, logf(p)));
  }
};

template <>
struct Split<double> {
  static constexpr int kBias = 1023;
  __device__ static double min_normal() { return 2.2250738585072014e-308; }
  __device__ static double max_finite() { return 1.7976931348623157e+308; }
  __device__ static double take(double x, int& e) {
    const int hi = __double2hiint(x);
    e += hi >> 20;
    return __hiloint2double(and_or(hi, 0x000fffffu, 0x3ff00000u),
                            __double2loint(x));
  }
  // take(max(|d|, fl)), or take(1.0) for a masked term.  |d| is never
  // formed: the compare reads it, the significand ignores the sign bit and
  // the exponent field is masked out of the high word.  A NaN d takes the
  // floor, as fmax(NaN, fl) does.
  __device__ static double term(double d, double fl, bool valid, int& e) {
    const bool big = fabs(d) > fl;
    int hi = big ? __double2hiint(d) : __double2hiint(fl);
    int lo = big ? __double2loint(d) : __double2loint(fl);
    if (!valid) {
      hi = 0x3ff00000;
      lo = 0;
    }
    e += static_cast<int>((static_cast<unsigned>(hi) & 0x7ff00000u) >> 20);
    return __hiloint2double(and_or(hi, 0x000fffffu, 0x3ff00000u), lo);
  }
  // log(p) + e ln2, with ln2 = 0x3fe62e42fefa39ef + 0x3c7abc9e3b39803f.
  __device__ static double finish(double p, int e) {
    const double fe = static_cast<double>(e);
    return fma(fe, 0.6931471805599453094, fma(fe, 2.3190468138462996e-17,
                                              log(p)));
  }
};

// The terms of one staged chunk for the kRows rows of this thread.
template <typename T, bool kMasked, int kRows>
__device__ __forceinline__ void chunk_products(
    const T (*smu)[kChunkK + 1], const unsigned char (*smask)[kChunkK + 1],
    int kc, const T* li, T fl, T* p, int* ex) {
  for (int kk = 0; kk < kc; ++kk) {
    const T m = smu[threadIdx.x][kk];
    bool valid = true;
    if constexpr (kMasked) valid = smask[threadIdx.x][kk] != 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      p[r] *= Split<T>::term(li[r] - m, fl, valid, ex[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) p[r] = Split<T>::take(p[r], ex[r]);
}

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
  const int i0 = blockIdx.y * kTileI + threadIdx.y;  // row r: i0 + r * 8
  const int j = j0 + threadIdx.x;
  const int tid = threadIdx.y * kTileJ + threadIdx.x;
  // Rows of this warp that exist: the same for all its threads.
  const int rows =
      i0 < I ? min(kRowsI, (I - i0 + kThreadsI - 1) / kThreadsI) : 0;
  // The floor is a positive normal number: the block takes the split path.
  const bool split = fl >= Split<T>::min_normal() && fl <= Split<T>::max_finite();

  T li[kRowsI], acc[kRowsI];
  int ex[kRowsI];
#pragma unroll
  for (int r = 0; r < kRowsI; ++r) {
    li[r] = r < rows ? lam[i0 + r * kThreadsI] : T(0);
    acc[r] = split ? T(1) : T(0);
    ex[r] = 0;
  }

  // The next chunk's mu (and mask) values of this thread, loaded from
  // device memory while the current chunk is summed.
  constexpr int kLoads = kChunkK / kThreadsI;
  T next[kLoads];
  unsigned char next_mask[kLoads];
  auto fetch = [&](int k0) {
    const int kc = min(kChunkK, K - k0);
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int idx = tid + l * kTileJ * kThreadsI;
      const int jj = idx / kChunkK;
      const int kk = idx % kChunkK;
      const bool in = j0 + jj < J && kk < kc;
      const size_t at = static_cast<size_t>(j0 + jj) * K + k0 + kk;
      next[l] = in ? mu[at] : T(0);
      if constexpr (kMasked) next_mask[l] = in ? mask[at] : 0;
    }
  };
  if (K > 0) fetch(0);

  int chunks = 0;
  for (int k0 = 0; k0 < K; k0 += kChunkK, ++chunks) {
    const int kc = min(kChunkK, K - k0);
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int idx = tid + l * kTileJ * kThreadsI;
      smu[idx / kChunkK][idx % kChunkK] = next[l];
      if constexpr (kMasked) smask[idx / kChunkK][idx % kChunkK] = next_mask[l];
    }
    __syncthreads();
    if (k0 + kChunkK < K) fetch(k0 + kChunkK);
    if (split) {
      switch (rows) {
        case 4:
          chunk_products<T, kMasked, 4>(smu, smask, kc, li, fl, acc, ex);
          break;
        case 3:
          chunk_products<T, kMasked, 3>(smu, smask, kc, li, fl, acc, ex);
          break;
        case 2:
          chunk_products<T, kMasked, 2>(smu, smask, kc, li, fl, acc, ex);
          break;
        case 1:
          chunk_products<T, kMasked, 1>(smu, smask, kc, li, fl, acc, ex);
          break;
        default:
          break;
      }
    } else {
      for (int kk = 0; kk < kc; ++kk) {
        const T m = smu[threadIdx.x][kk];
#pragma unroll
        for (int r = 0; r < kRowsI; ++r) {
          const T term = log(fmax(fabs(li[r] - m), fl));
          if constexpr (kMasked) {
            acc[r] += smask[threadIdx.x][kk] ? term : T(0);
          } else {
            acc[r] += term;
          }
        }
      }
    }
    __syncthreads();
  }
  if (j >= J) return;
  // Every term and every re-split added a biased exponent field.
  const int bias = Split<T>::kBias * (K + chunks);
#pragma unroll
  for (int r = 0; r < kRowsI; ++r) {
    if (r < rows) {
      out[static_cast<size_t>(i0 + r * kThreadsI) * J + j] =
          split ? Split<T>::finish(acc[r], ex[r] - bias) : acc[r];
    }
  }
}

// At most 64 registers a thread: four blocks of 256 threads an SM.
template <typename T>
__global__ void __launch_bounds__(kTileJ * kThreadsI, 4) logabs_sum_kernel(const T* __restrict__ lam,
                                  const T* __restrict__ mu,
                                  const T* __restrict__ floor_,
                                  T* __restrict__ out, int I, int J, int K) {
  const size_t b = blockIdx.z;
  logabs_sum_block<T, false>(lam + b * I, mu + b * J * K, nullptr, floor_[b],
                             out + b * I * J, I, J, K);
}

template <typename T>
__global__ void __launch_bounds__(kTileJ * kThreadsI, 4) logabs_sum_masked_kernel(const T* __restrict__ lam,
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
  logabs_sum_kernel<T><<<grid_of(B, I, J), dim3(kTileJ, kThreadsI), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      lam, mu, floor_, out, I, J, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_logabs_sum_masked(const T* lam, const T* mu,
                             const unsigned char* mask, const T* floor_,
                             T* out, int B, int I, int J, int K,
                             void* stream) {
  logabs_sum_masked_kernel<T><<<grid_of(B, I, J), dim3(kTileJ, kThreadsI), 0,
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
