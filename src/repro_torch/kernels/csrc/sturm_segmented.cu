// Segment-masked Sturm-sequence bisection on packed tridiagonal bands, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `sturm_segmented_padded` /
// `_sturm_segmented_kernel` of src/repro/kernels/sturm/kernel.py (its
// pallas_call at line 159).  Lane (row, m) carries its own bracket lo, hi,
// its own pivmin, a segment [start, end) of band `row` and an eigenvalue
// index `target` of that segment.  Each of its n_iter bisections takes the
// count of the Sturm recurrence
//     q_0 = d_0 - x,   q_k = (d_k - x) - e_{k-1}^2 / q_{k-1},
//     |q| < pivmin -> -pivmin,   count = #{k in [start, end) : q_k < 0}
// run over the whole band, as the TPU kernel does; count <= target moves lo
// up, else hi down.  The kernel serves packed requests (several segments a
// row, a window of k lanes each) and warm session updates (one full-band
// segment a row, a bracket a lane).  Every output is bitwise the plain
// version's (linalg/sturm.py::bisect_lanes_segmented).
//
// What bounds it on an H100 SXM: the lanes' dependent recurrences.  The
// work any implementation must do is the steps inside each lane's own
// segment, 8 operations each plus the segment compare (PERF.md's bound);
// the kernel of one lane a thread before this design ran every lane over
// the whole band (S times that work on a row of S segments), kept 96 of
// its 128 threads idle on a row of 32 lanes, evaluated the same midpoints
// once per lane of a segment and ran every iteration after convergence.
// The design, lever by lever:
//
// 1. Steps inside the segment only.  Columns before `start` reach the
//    lane's count only through q, and where e_{j-1}^2 is exactly 0 the step
//    at j is (d_j - x) - 0 / q_{j-1}: with q_{j-1} finite and nonzero (the
//    clamp keeps |q| >= pivmin > 0) or infinite, 0 / q_{j-1} is a zero, the
//    difference is d_j - x exactly, or a zero that the clamp turns into
//    -pivmin either way.  So the recurrence restarted at j is bitwise the
//    continued one.  A lane walks from the last column j <= start with
//    j = 0 or e_{j-1}^2 == 0 (the junction of a packed row; a nonzero
//    junction walks back further, to 0 at worst) to end, and the steps
//    before `start` do not count.  The restart needs q_{j-1} not NaN.  With
//    pivmin > 0, finite d, finite e^2, max e^2 / pivmin finite and a finite
//    starting bracket, no step can form a NaN: e^2 / q stays finite, so the
//    only infinities come from d - x or a sum overflowing, and no step
//    subtracts two infinities.  The block checks this over the columns
//    before the walks it takes (whole-row max of e^2 before them); a lane
//    that fails it (non-finite entries, e^2 or e^2 / pivmin overflowing,
//    pivmin <= 0, a non-finite bracket) walks from column 0, as the plain
//    version does.  Stopping at `end` is always exact.
// 2. Shared brackets and a fixed-point exit, as in sturm.cu: adjacent lanes
//    with bitwise-equal lo, hi, pivmin, start and end and non-decreasing
//    targets form one bracket (lo, hi, first lane, last lane); one thread
//    evaluates its count, which splits it at the first lane whose target is
//    at least the count.  A bracket leaves the list at its fixed point (mid
//    equal to lo or hi bitwise, and 0.5 * (mid + mid) == mid).  After the
//    counts, one thread walks each path (a bracket and `depth` turns) in at
//    most three steps, without local arrays: on segments of 8 to 32 columns
//    a thread's walk of a whole subtree through arrays in local memory cost
//    a round more than its recurrence did.
// 3. Every thread busy: a round evaluates up to three levels of midpoints
//    where the block has threads to spare, each formed from its own node's
//    [lo, hi] as bisection forms it.  The wrapper
//    (kernels/sturm/kernel.py::_segmented_geometry) gives a block the lanes
//    of one segment (or of one row) and threads for three levels a round
//    where the launch is too small to fill the card, one a lane where it is
//    large.
// 4. The block stages only the columns its lanes walk (d_k and e_{k-1}^2
//    side by side) in shared memory; a block whose walks span more columns
//    than the launch's window reads the band from device memory instead,
//    with the same arithmetic, so a band of any length runs.
//
// Arithmetic: as sturm.cu.  IEEE divides (no --use_fast_math),
// (d_k - x) - e^2 / q in its order, the compare |q| < pivmin and the select
// as in the plain version, q < 0 as a signed integer compare of q's high
// word (float32: its bits) with -inf's.
//
// What bounds it now, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md,
// section 6, tools/kernel_times.py): at the synthetic packed shape (2400
// rows of 4 segments of 599, k = 8) the FP64 pipe and the issue of the
// recurrence, speculative levels included; at the packed program's launch
// and the session's band, the latency of a round (one segment's dependent
// recurrence, then the walk and two barriers) times its rounds, about 22
// in float64 and 11 in float32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sturm_common.cuh"

namespace {

constexpr int kMaxDepth = 3;
constexpr int kMaxThreads = 640;

// Order-preserving keys of non-negative numbers, for an atomic max.
__device__ __forceinline__ unsigned int key_of(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ unsigned long long key_of(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(x));
}
__device__ __forceinline__ float value_of(unsigned int k) {
  return __uint_as_float(k);
}
__device__ __forceinline__ double value_of(unsigned long long k) {
  return __longlong_as_double(static_cast<long long>(k));
}
template <typename T>
struct Key;
template <>
struct Key<float> {
  using type = unsigned int;
};
template <>
struct Key<double> {
  using type = unsigned long long;
};

// The band staged in shared memory: columns [base, base + window).
template <typename T>
struct SharedBand {
  const Step<T>* s;
  int base;
  __device__ __forceinline__ Step<T> at(int k) const { return s[k - base]; }
};

// The band read from device memory (e_{k-1}^2 formed at each step, as the
// staging forms it).
template <typename T>
struct GlobalBand {
  const T* d;
  const T* e;
  __device__ __forceinline__ Step<T> at(int k) const {
    const T ek = k > 0 ? e[k - 1] : T(0);
    return {d[k], ek * ek};
  }
};

// Number of eigenvalues below x of the block [start, end) whose walk
// starts at column `from` (from <= start, or from == end for an empty one).
template <typename T, typename Band>
__device__ __forceinline__ int segment_count(const Band& band, int from,
                                             int start, int end, T x,
                                             T pivmin, T neg_piv) {
  if (from >= end) return 0;
  T q = band.at(from).d - x;
  if (fabs(q) < pivmin) q = neg_piv;
  int count = from >= start ? negative(q) : 0;
  int k = from + 1;
  for (; k < start; ++k) {  // steps before the segment: q only
    const Step<T> s = band.at(k);
    q = (s.d - x) - s.e2 / q;
    if (fabs(q) < pivmin) q = neg_piv;
  }
#pragma unroll 4
  for (; k < end; ++k) {
    const Step<T> s = band.at(k);
    q = (s.d - x) - s.e2 / q;
    if (fabs(q) < pivmin) q = neg_piv;
    count += negative(q);
  }
  return count;
}

// The lanes' per-lane state in shared memory, indexed by lane - lane0.
template <typename T>
struct Lanes {
  T* piv;
  int* target;
  int* from;
  int* start;
  int* end;
};

// First lane of [first, last] whose target is at least c (last + 1 if
// none): targets are non-decreasing within a bracket.
__device__ __forceinline__ int split_lane(const int* __restrict__ target,
                                          int lane0, int first, int last,
                                          int c) {
  int lo = first, hi = last + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (target[mid - lane0] >= c) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// Shared memory of one block: the window of the band, the lanes' pivmin,
// two bracket lists of `cap` entries, the lanes' four ints and the list's
// two, and the counts of one round (at most max(cap, threads)).
template <typename T>
size_t shared_bytes(int window, int cap, int threads) {
  return 2 * static_cast<size_t>(window) * sizeof(T) +
         5 * static_cast<size_t>(cap) * sizeof(T) +
         (8 * static_cast<size_t>(cap) + max(cap, threads)) * sizeof(int);
}

template <typename T, typename Band>
__device__ void bisect_tree(const Band& band, const Lanes<T>& ln,
                            List<T>* list, int* cnt, int* s_next, int nb,
                            int lane0, int n_iter, T* __restrict__ orow) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  int cur = 0, it = 0, round = 0;
  while (nb > 0 && it < n_iter) {
    int depth = 1;
    while (depth < kMaxDepth && depth < n_iter - it &&
           nb * ((2 << depth) - 1) <= static_cast<int>(blockDim.x)) {
      ++depth;
    }
    const int nodes = (1 << depth) - 1;
    const List<T> in = list[cur];
    const List<T> outl = list[cur ^ 1];

    for (int ev = tid; ev < nb * nodes; ev += blockDim.x) {
      const int g = in.first[ev / nodes] - lane0;
      const T piv = ln.piv[g];
      cnt[ev] = segment_count<T>(band, ln.from[g], ln.start[g], ln.end[g],
                                 node_mid(in, ev, nodes), piv, negated(piv));
    }
    const int par = round & 1;
    __syncthreads();
    if (tid == 0) s_next[par ^ 1] = 0;

    // Walk the subtrees with the counts: one thread a potential leaf (a
    // bracket and a path of `depth` left / right turns), no thread more
    // than `depth` steps.  A fixed point writes its lanes (the first path
    // under each of its children does), a live leaf goes to the next list.
    const int paths = nb << depth;
    for (int w0 = 0; w0 < paths; w0 += blockDim.x) {
      const int w = w0 + tid;
      int nl = 0;
      T lo, hi;
      int first, last;
      if (w < paths) {
        const int b = w >> depth;
        const int path = w & ((1 << depth) - 1);
        lo = in.lo[b];
        hi = in.hi[b];
        first = in.first[b];
        last = in.last[b];
        int node = 0;
        nl = 1;
        for (int level = 0; level < depth; ++level) {
          const int below = depth - 1 - level;
          const int right = (path >> below) & 1;
          const T mid = T(0.5) * (lo + hi);
          const int c = cnt[b * nodes + node];
          const int split = split_lane(ln.target, lane0, first, last, c);
          if (fixed(lo, hi, mid)) {
            if ((path & ((1 << below) - 1)) == 0) {
              if (!right && first < split) {
                fill(orow, first, split - 1, T(0.5) * (lo + mid));
              }
              if (right && split <= last) {
                fill(orow, split, last, T(0.5) * (mid + hi));
              }
            }
            nl = 0;
            break;
          }
          if (right) {
            lo = mid;
            first = split;
            node = 2 * node + 2;
          } else {
            hi = mid;
            last = split - 1;
            node = 2 * node + 1;
          }
          if (first > last) {
            nl = 0;
            break;
          }
        }
      }
      int incl = nl;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      int base = 0;
      if (lane == 31 && incl > 0) base = atomicAdd(&s_next[par], incl);
      base = __shfl_sync(0xffffffffu, base, 31) + incl - nl;
      if (nl) {
        outl.lo[base] = lo;
        outl.hi[base] = hi;
        outl.first[base] = first;
        outl.last[base] = last;
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
__global__ void __launch_bounds__(kMaxThreads)
    sturm_segmented_kernel(const T* __restrict__ d, const T* __restrict__ e,
                           const T* __restrict__ lo_in,
                           const T* __restrict__ hi_in,
                           const T* __restrict__ piv_in,
                           const int* __restrict__ start_in,
                           const int* __restrict__ end_in,
                           const int* __restrict__ target_in,
                           T* __restrict__ out, int n, int m, int n_iter,
                           int cap, int window) {
  using K = typename Key<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_next[2];
  __shared__ int s_prefix, s_lo_col, s_hi_col, s_bad;
  __shared__ K s_e2max;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int lane0 = blockIdx.y * cap;
  const int lanes = min(cap, m - lane0);
  if (lanes <= 0) return;

  Step<T>* staged = reinterpret_cast<Step<T>*>(smem_raw);
  T* piv = reinterpret_cast<T*>(staged + window);
  List<T> list[2];
  list[0].lo = piv + cap;
  list[0].hi = list[0].lo + cap;
  list[1].lo = list[0].hi + cap;
  list[1].hi = list[1].lo + cap;
  int* ints = reinterpret_cast<int*>(list[1].hi + cap);
  Lanes<T> ln{piv, ints, ints + cap, ints + 2 * cap, ints + 3 * cap};
  list[0].first = ints + 4 * cap;
  list[0].last = list[0].first + cap;
  list[1].first = list[0].last + cap;
  list[1].last = list[1].first + cap;
  int* cnt = list[1].last + cap;

  const size_t row = blockIdx.x;
  const T* drow = d + row * n;
  const T* erow = e + row * (n - 1);
  const size_t lrow = row * m + lane0;
  if (tid == 0) {
    s_next[0] = 0;
    s_next[1] = 0;
    s_prefix = 0;
    s_lo_col = n;
    s_hi_col = 0;
    s_bad = 0;
    s_e2max = 0;
  }
  // Each lane's segment, clamped to the band, and the restart column of its
  // walk; its bracket goes to list 1 for the grouping below.
  T* lane_lo = list[1].lo;
  T* lane_hi = list[1].hi;
  __syncthreads();
  for (int l = tid; l < lanes; l += blockDim.x) {
    const size_t idx = lrow + l;
    const int s = min(max(start_in[idx], 0), n);
    const int en = max(min(end_in[idx], n), s);
    int j = s;
    if (en > s) {
      while (j > 0) {
        const T ej = erow[j - 1];
        if (ej * ej == T(0)) break;
        --j;
      }
    } else {
      j = en;
    }
    lane_lo[l] = lo_in[idx];
    lane_hi[l] = hi_in[idx];
    piv[l] = piv_in[idx];
    ln.target[l] = target_in[idx];
    ln.start[l] = s;
    ln.end[l] = en;
    ln.from[l] = j;
    if (j < en) atomicMax(&s_prefix, j);
  }
  __syncthreads();
  // The columns before the latest restart: finite d and e^2, and their
  // largest e^2.
  const int prefix = s_prefix;
  {
    int bad = 0;
    T e2max = T(0);
    for (int k = tid; k < prefix; k += blockDim.x) {
      const T ek = k > 0 ? erow[k - 1] : T(0);
      const T e2 = ek * ek;
      bad |= !isfinite(drow[k]) || !isfinite(e2);
      if (e2 > e2max) e2max = e2;
    }
    if (bad) atomicOr(&s_bad, 1);
    if (e2max > T(0)) atomicMax(&s_e2max, key_of(e2max));
  }
  __syncthreads();
  const bool prefix_bad = s_bad != 0;
  const T e2max = value_of(s_e2max);
  for (int l = tid; l < lanes; l += blockDim.x) {
    int j = ln.from[l];
    const T p = piv[l];
    if (j > 0 && j < ln.end[l] &&
        (prefix_bad || !(p > T(0)) || !isfinite(e2max / p) ||
         !isfinite(lane_lo[l]) || !isfinite(lane_hi[l]))) {
      j = 0;  // a NaN could reach the junction: walk the whole prefix
      ln.from[l] = 0;
    }
    if (j < ln.end[l]) {
      atomicMin(&s_lo_col, j);
      atomicMax(&s_hi_col, ln.end[l]);
    }
    // A bracket starts where a lane's state differs from the lane before.
    bool head = l == 0;
    if (!head) {
      head = !same(lane_lo[l], lane_lo[l - 1]) ||
             !same(lane_hi[l], lane_hi[l - 1]) || !same(p, piv[l - 1]) ||
             ln.start[l] != ln.start[l - 1] || ln.end[l] != ln.end[l - 1] ||
             ln.target[l] < ln.target[l - 1];
    }
    cnt[l] = head;
  }
  __syncthreads();
  // Stage the columns the block's lanes walk, if they fit the window.
  const int lo_col = s_lo_col;
  const int span = s_hi_col - lo_col;
  const bool in_shared = span <= window;
  if (in_shared) {
    for (int k = tid; k < span; k += blockDim.x) {
      const int c = lo_col + k;
      const T ek = c > 0 ? erow[c - 1] : T(0);
      staged[k] = {drow[c], ek * ek};
    }
  }
  // The initial list: one bracket per run of lanes with the same state,
  // appended in any order (a scan over the warp, one atomic per warp).
  for (int l0 = 0; l0 < lanes; l0 += blockDim.x) {
    const int l = l0 + tid;
    int nl = 0, last = l;
    if (l < lanes && cnt[l]) {
      nl = 1;
      while (last + 1 < lanes && !cnt[last + 1]) ++last;
    }
    int incl = nl;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    int base = 0;
    if (lane == 31 && incl > 0) base = atomicAdd(&s_next[0], incl);
    base = __shfl_sync(0xffffffffu, base, 31) + incl - nl;
    if (nl) {
      list[0].lo[base] = lane_lo[l];
      list[0].hi[base] = lane_hi[l];
      list[0].first[base] = lane0 + l;
      list[0].last[base] = lane0 + last;
    }
  }
  __syncthreads();
  const int nb = s_next[0];
  __syncthreads();
  if (tid == 0) s_next[0] = 0;

  T* orow = out + row * m;
  if (in_shared) {
    bisect_tree<T>(SharedBand<T>{staged, lo_col}, ln, list, cnt, s_next, nb,
                   lane0, n_iter, orow);
  } else {
    bisect_tree<T>(GlobalBand<T>{drow, erow}, ln, list, cnt, s_next, nb,
                   lane0, n_iter, orow);
  }
}

template <typename T>
int launch_sturm_segmented(const T* d, const T* e, const T* lo, const T* hi,
                           const T* pivmin, const int* start, const int* end,
                           const int* target, T* out, int rows, int n, int m,
                           int n_iter, int cap, int threads, int window,
                           void* stream) {
  if (cap < 1 || threads < 32 || threads % 32 || threads > kMaxThreads ||
      window < 0 || window > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = shared_bytes<T>(window, cap, threads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sturm_segmented_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(rows, (m + cap - 1) / cap);
  sturm_segmented_kernel<T><<<grid, threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      d, e, lo, hi, pivmin, start, end, target, out, n, m, n_iter, cap,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cap: lanes a block; threads: block size, a multiple of 32, at most 640;
// window: columns of the band a block stages in shared memory (at most n).
extern "C" int sturm_segmented_f32(const float* d, const float* e,
                                   const float* lo, const float* hi,
                                   const float* pivmin, const int* start,
                                   const int* end, const int* target,
                                   float* out, int rows, int n, int m,
                                   int n_iter, int cap, int threads,
                                   int window, void* stream) {
  return launch_sturm_segmented<float>(d, e, lo, hi, pivmin, start, end,
                                       target, out, rows, n, m, n_iter, cap,
                                       threads, window, stream);
}

extern "C" int sturm_segmented_f64(const double* d, const double* e,
                                   const double* lo, const double* hi,
                                   const double* pivmin, const int* start,
                                   const int* end, const int* target,
                                   double* out, int rows, int n, int m,
                                   int n_iter, int cap, int threads,
                                   int window, void* stream) {
  return launch_sturm_segmented<double>(d, e, lo, hi, pivmin, start, end,
                                        target, out, rows, n, m, n_iter, cap,
                                        threads, window, stream);
}
