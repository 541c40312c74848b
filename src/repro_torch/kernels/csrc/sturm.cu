// Sturm-sequence bisection eigenvalues of a stack of symmetric tridiagonal
// bands, for Hopper (sm_90a).
//
// Replaces the TPU kernel `sturm_padded` / `_sturm_kernel` of
// src/repro/kernels/sturm/kernel.py (its pallas_call at line 197).  Lane
// (row, m) bisects n_iter times for eigenvalue index target_base + m of band
// `row`; each bisection runs the Sturm recurrence
//     q_0 = d_0 - x,   q_k = (d_k - x) - e_{k-1}^2 / q_{k-1},
//     |q| < pivmin -> -pivmin,   count = #{k : q_k < 0}
// over exactly n steps.  count <= target moves lo up, else hi down.  Every
// output is bitwise the plain version's (linalg/sturm.py::bisect_lanes).
//
// Design: a bisection tree per block, in which every distinct bracket is
// evaluated once.  All lanes of a row start from the same [lo, hi], so after
// t iterations there are at most 2^t distinct states: a block keeps a
// compacted list of brackets (lo, hi, first lane, last lane) in shared
// memory.  One thread evaluates one bracket's count at mid = 0.5 * (lo + hi)
// and splits it: lanes whose target is below the count go to [lo, mid], the
// others to [mid, hi], and empty children are dropped.  After t levels each
// bracket's state is bit for bit the state every lane in it has after t
// plain iterations.  A bracket leaves the list once the iteration has
// reached a fixed point: mid equals lo or hi (bit patterns), so one child is
// the parent itself and the other is collapsed to [mid, mid] with
// 0.5 * (mid + mid) == mid (also checked); every later iteration recomputes
// the same mid and count, so its lanes get 0.5 * (lo + hi) of that child
// now, exactly what n_iter iterations give.  Lanes whose eigenvalues never
// separate (repeated eigenvalues) stay one bracket.
//
// A round takes up to three levels at once where the block has threads to
// spare (at most one evaluation a thread): it evaluates the 2^depth - 1
// midpoints of the next `depth` levels of every bracket (each formed
// exactly as bisection forms it, from the node's own [lo, hi]) and then
// walks them with those counts.  So the first levels of a row, and its last
// few unconverged brackets, take a third of the rounds, which are bound by
// the latency of one n-step dependent chain, not by the card's throughput.
//
// Geometry, chosen by the wrapper (kernels/sturm/kernel.py::_geometry) from
// (rows, m): a block takes lanes [p * cap, (p + 1) * cap) of its row (grid
// (rows, parts)).  A large stack (the 9600 minor bands) runs one block of
// round_up(m, 32) threads per row, three blocks an SM, so that one block's
// latency-bound rounds overlap the others' full ones.  A small launch (the
// 16-band spectrum, the k-windows) splits each row's lanes over enough
// blocks to reach every SM, with threads for three levels a round.
//
// Arithmetic: the compare |q| < pivmin and the select stay as in the plain
// version, and q < 0 is a signed integer compare of q's high word with
// -inf's (float32: of its bits), exact for every number and infinity (q is
// never -0 after the clamp, as pivmin > 0) and for every NaN the card's
// arithmetic produces.  The divide stays IEEE (no --use_fast_math: an
// approximate divide moves counts at zero crossings), and
// (d_k - x) - e^2 / q keeps its order.
//
// Bound on an H100 SXM: instruction issue.  The nominal work of PERF.md's
// bound is 8 operations a recurrence step; the main path's minor-spectra
// launch is 9600 rows x 599 lanes x 64 iterations x 599 steps, about 2.2e11
// steps, bound at 51.9 ms against the 34 TFLOP/s FP64 peak (13.2 ms in
// float32 at 32 iterations and 67 TFLOP/s).  The tree and the fixed-point
// exit run about 0.75 (float32: 0.6) of those steps (the numpy model's count
// on the smoke's minor bands, tests/test_torch_kernel_design.py).  A step's
// fast path in the SASS of the inner loop issues 26.25 instructions in
// float64: 11 FP64 (two subtracts, the divide's eight fused multiply-adds
// and multiply), 5 on the FP32 pipe (the divide's range check, the select),
// one reciprocal seed, 5 integer, one shared load and 3.25 branches and
// barriers; 19.25 in float32.  At one warp instruction a clock per
// scheduler that is 26 clocks a warp-step against the 22 the FP64 pipe
// needs, so issue binds, as it did for the kernel of one lane a thread
// (29.25 instructions, 13 of them FP64).  Measured on an NVIDIA H100 80GB
// HBM3 at 700 W (chip_smoke.py): 194.3 ms (float64) and 47.3 ms (float32)
// for the minor stack, against 271.8 and 81.8 ms for the kernel of one lane
// a thread; every number is in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sturm_common.cuh"

namespace {

// Most tree levels a round evaluates at once.
constexpr int kMaxDepth = 3;
// Block limits: up to 640 threads (one evaluation each) and three blocks an
// SM, so at most 34 registers a thread.
constexpr int kMaxThreads = 640;
constexpr int kMinBlocks = 3;

// Number of eigenvalues of the band below x.
template <typename T>
__device__ __forceinline__ int sturm_count(const Step<T>* __restrict__ band,
                                           int n, T x, T pivmin, T neg_piv) {
  T q = band[0].d - x;
  if (fabs(q) < pivmin) q = neg_piv;
  int count = negative(q);
#pragma unroll 4
  for (int k = 1; k < n; ++k) {
    const Step<T> s = band[k];
    q = (s.d - x) - s.e2 / q;
    if (fabs(q) < pivmin) q = neg_piv;
    count += negative(q);
  }
  return count;
}

template <typename T>
struct Bracket {
  T lo, hi;
  int first, last, node;
};

// Shared memory of one block: the band (d, e^2 pairs), two bracket lists of
// `cap` entries and the counts of one round (at most max(cap, threads)).
template <typename T>
size_t shared_bytes(int n, int cap, int threads) {
  return 2 * static_cast<size_t>(n) * sizeof(T) +
         4 * static_cast<size_t>(cap) * sizeof(T) +
         (4 * static_cast<size_t>(cap) + max(cap, threads)) * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    sturm_bisect_kernel(const T* __restrict__ d, const T* __restrict__ e,
                        const T* __restrict__ bounds, T* __restrict__ out,
                        int n, int m, int target_base, int n_iter, int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_next[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int lane0 = blockIdx.y * cap;
  const int lanes = min(cap, m - lane0);
  if (lanes <= 0) return;

  Step<T>* band = reinterpret_cast<Step<T>*>(smem_raw);
  List<T> list[2];
  list[0].lo = reinterpret_cast<T*>(band + n);
  list[0].hi = list[0].lo + cap;
  list[1].lo = list[0].hi + cap;
  list[1].hi = list[1].lo + cap;
  list[0].first = reinterpret_cast<int*>(list[1].hi + cap);
  list[0].last = list[0].first + cap;
  list[1].first = list[0].last + cap;
  list[1].last = list[1].first + cap;
  int* cnt = list[1].last + cap;

  const size_t row = blockIdx.x;
  const T* drow = d + row * n;
  const T* erow = e + row * (n - 1);
  for (int k = tid; k < n; k += blockDim.x) {
    const T ek = k > 0 ? erow[k - 1] : T(0);
    band[k] = {drow[k], ek * ek};
  }
  const T pivmin = bounds[row * 3 + 2];
  const T neg_piv = negated(pivmin);
  // Brackets hold lane indices: lane l targets eigenvalue target_base + l
  // and writes orow[l].
  T* orow = out + row * m;
  if (tid == 0) {
    list[0].lo[0] = bounds[row * 3 + 0];
    list[0].hi[0] = bounds[row * 3 + 1];
    list[0].first[0] = lane0;
    list[0].last[0] = lane0 + lanes - 1;
    s_next[0] = 0;
    s_next[1] = 0;
  }
  __syncthreads();

  int nb = 1, cur = 0, it = 0, round = 0;
  while (nb > 0 && it < n_iter) {
    // As many levels as the threads evaluate in one pass, at most kMaxDepth.
    int depth = 1;
    while (depth < kMaxDepth && depth < n_iter - it &&
           nb * ((2 << depth) - 1) <= static_cast<int>(blockDim.x)) {
      ++depth;
    }
    const int nodes = (1 << depth) - 1;
    const List<T> in = list[cur];
    const List<T> outl = list[cur ^ 1];

    for (int ev = tid; ev < nb * nodes; ev += blockDim.x) {
      cnt[ev] = sturm_count(band, n, node_mid(in, ev, nodes), pivmin,
                            neg_piv);
    }
    const int par = round & 1;
    __syncthreads();
    if (tid == 0) s_next[par ^ 1] = 0;

    // Walk each bracket's subtree with the counts; a fixed point writes its
    // lanes, the leaves go to the next list.
    for (int b0 = 0; b0 < nb; b0 += blockDim.x) {
      const int b = b0 + tid;
      Bracket<T> lvl[1 << kMaxDepth];
      int nl = 0;
      if (b < nb) {
        lvl[0] = {in.lo[b], in.hi[b], in.first[b], in.last[b], 0};
        nl = 1;
      }
      for (int level = 0; level < depth; ++level) {
        Bracket<T> kids[1 << kMaxDepth];
        int nk = 0;
        for (int s = 0; s < nl; ++s) {
          const Bracket<T> br = lvl[s];
          const T mid = T(0.5) * (br.lo + br.hi);
          const int c = cnt[b * nodes + br.node] - target_base;
          const int lf = br.first, ll = min(br.last, c - 1);
          const int rf = max(br.first, c), rl = br.last;
          if (fixed(br.lo, br.hi, mid)) {
            if (lf <= ll) fill(orow, lf, ll, T(0.5) * (br.lo + mid));
            if (rf <= rl) fill(orow, rf, rl, T(0.5) * (mid + br.hi));
          } else {
            if (lf <= ll) kids[nk++] = {br.lo, mid, lf, ll, 2 * br.node + 1};
            if (rf <= rl) kids[nk++] = {mid, br.hi, rf, rl, 2 * br.node + 2};
          }
        }
        for (int s = 0; s < nk; ++s) lvl[s] = kids[s];
        nl = nk;
      }
      // Append the leaves: a scan over the warp, one atomic per warp.
      int incl = nl;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      int base = 0;
      if (lane == 31 && incl > 0) base = atomicAdd(&s_next[par], incl);
      base = __shfl_sync(0xffffffffu, base, 31) + incl - nl;
      for (int s = 0; s < nl; ++s) {
        outl.lo[base + s] = lvl[s].lo;
        outl.hi[base + s] = lvl[s].hi;
        outl.first[base + s] = lvl[s].first;
        outl.last[base + s] = lvl[s].last;
      }
    }
    __syncthreads();
    nb = s_next[par];
    cur ^= 1;
    it += depth;
    ++round;
  }

  const List<T> rest = list[cur];
  for (int b = tid; b < nb; b += blockDim.x) {
    fill(orow, rest.first[b], rest.last[b],
         T(0.5) * (rest.lo[b] + rest.hi[b]));
  }
}

template <typename T>
int launch_sturm_bisect(const T* d, const T* e, const T* bounds, T* out,
                        int rows, int n, int m, int target_base, int n_iter,
                        int cap, int threads, void* stream) {
  if (cap < 1 || threads < 32 || threads % 32 || threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = shared_bytes<T>(n, cap, threads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sturm_bisect_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(rows, (m + cap - 1) / cap);
  sturm_bisect_kernel<T><<<grid, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      d, e, bounds, out, n, m, target_base, n_iter, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cap: lanes per block; threads: block size, a multiple of 32, at most 640.
extern "C" int sturm_bisect_f32(const float* d, const float* e,
                                const float* bounds, float* out, int rows,
                                int n, int m, int target_base, int n_iter,
                                int cap, int threads, void* stream) {
  return launch_sturm_bisect<float>(d, e, bounds, out, rows, n, m,
                                    target_base, n_iter, cap, threads,
                                    stream);
}

extern "C" int sturm_bisect_f64(const double* d, const double* e,
                                const double* bounds, double* out, int rows,
                                int n, int m, int target_base, int n_iter,
                                int cap, int threads, void* stream) {
  return launch_sturm_bisect<double>(d, e, bounds, out, rows, n, m,
                                     target_base, n_iter, cap, threads,
                                     stream);
}
