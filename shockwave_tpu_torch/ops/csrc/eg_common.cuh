// Shared pieces of the one-block-per-problem planning kernels
// (eg_pdhg.cu, eg_relaxed.cu): the block shape, the deterministic block
// reductions, the bisection tree and the budget projection both solvers
// run.
//
// A problem's job axis is padded to `slots` and owned by one block of
// THREADS threads: thread t owns slots t, t + THREADS, ... for the whole
// solve. Every per-job update reads and writes only the slots its thread
// owns, so per-job state (in shared memory where it fits, else in global
// memory) needs no barrier between a write and the next read; only the
// global reductions synchronise.
//
// Reductions are deterministic: each thread sums (or takes the max of)
// its own slots in ascending order, a warp combines its 32 partials
// pairwise (lanes l and l^16, then ^8, ^4, ^2, ^1), one __syncthreads, and
// the 32 warp results are combined in the same pairwise order. No atomics,
// so two runs give bit-identical results. Two paths take that order:
//  - Reducer::reduce runs the full 5-stage xor butterfly on every value,
//    twice (5 N shuffles each time), so every lane holds every result;
//  - Reducer::over, for a bisection tree's 2^L - 1 loads, halves
//    recursively inside a warp (N + 4 to 2 N shuffles; lane k ends with
//    value k), writes one row of partials a warp, and lane k of every warp
//    combines the 32 warp partials of value k in the butterfly's order.
//    IEEE + is commutative, so each pair's result is the butterfly's bit
//    for bit.
// A reduction is bound by the SM's rate of shuffles and shared loads
// (every warp combines the warp partials itself), not by the barrier: so
// outside the sequential structure the warps that own no slot (all but
// ceil(slots / 32) of them below 1024 slots) return at the start, and
// the others synchronise alone (bar.sync 1, count). The second stage pads
// the missing warps' rows with the identities they would have
// contributed, so the sums keep their bits; the bisection trees pay
// where few warps remain.
// Shared memory is double-buffered: reduction n+1 writes the other
// buffer, and reduction n+2 may only reuse this one after every thread has
// passed reduction n+1's barrier, which it reaches after reading reduction
// n's results. So a fused reduction costs one block barrier.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The kernels' per-job state in dynamic shared memory (the host stand-in
// of tests/cuda_host defines its own).
#ifndef EG_DYNAMIC_SHARED
#define EG_DYNAMIC_SHARED(name)                         \
  extern __shared__ float4 name##_raw[];                \
  float* name = reinterpret_cast<float*>(name##_raw)
#endif

// Barrier 1 of `count` threads (a multiple of 32): the warps of the block
// that own slots, when the others have returned (the host stand-in of
// tests/cuda_host defines its own).
#ifndef EG_BAR_SYNC
#define EG_BAR_SYNC(count) asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory")
#endif

namespace eg {

// Threads of a problem's block (a multiple of 32, at most 1024). The
// numerics do not depend on it beyond the order of the sums.
#ifdef EG_THREADS
constexpr int THREADS = EG_THREADS;
#else
constexpr int THREADS = 1024;
#endif
constexpr int WARPS = THREADS / 32;
static_assert(THREADS % 32 == 0 && WARPS <= 32, "block of 32 to 1024 threads");
constexpr float EPS = 1e-6f;
constexpr unsigned FULL = 0xffffffffu;
// Levels of the deepest bisection tree: its 2^5 - 1 = 31 loads fuse into
// one reduction of at most 32 values.
constexpr int MAX_LEVELS = 5;
// Shared memory a block may take on an H100 (static and dynamic
// together, after cudaFuncSetAttribute).
constexpr int MAX_SHARED = 232448;

// Values a full reduction fuses at most; its rows keep this stride (a
// two-way bank conflict where lane l reads row l).
constexpr int FUSED_MAX = 6;
// Row stride of the tree's partials: a lane reading row l of its own
// index, or column k of every row, meets no bank conflict.
constexpr int ROW = 33;

// A block's static shared memory: the reductions' double buffer, one
// layout or the other in each half.
struct Shared {
  union {
    float fused[WARPS][FUSED_MAX];  // Reducer::reduce
    float rows[WARPS][ROW];         // Reducer::over, N > 1
  } red[2];
};

// Stage H (16, 8, ..., 1) of the recursive halving of N values across the
// lanes, NS sums then maxima: entry i stands for slot base + i before the
// stage; the lane keeps the half of its slots whose bit H is its own,
// takes its partner's copy of them and sends the other half. After stage 1
// lane k holds slot k, combined over the lanes in the xor butterfly's
// pairwise order. Template recursion keeps every index a constant, so `a`
// stays in registers.
template <int NS, int N, int H>
__device__ __forceinline__ void halve(float (&a)[32], int lane) {
  const bool upper = (lane & H) != 0;
  const int base = lane & ~(2 * H - 1) & 31;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    if (i < N || i + H < N) {  // else no lane holds a value there
      const float keep = upper ? a[i + H] : a[i];
      const float send = upper ? a[i] : a[i + H];
      const float got = __shfl_xor_sync(FULL, send, H);
      const bool is_sum = NS == N ? true : (NS == 0 ? false : base + i + (upper ? H : 0) < NS);
      a[i] = is_sum ? keep + got : fmaxf(keep, got);
    }
  }
  if constexpr (H > 1) halve<NS, N, H / 2>(a, lane);
}

// w[i] combined with w[i + H], then with H / 2, ... into w[0]: the
// butterfly's pairwise order over 2H entries.
template <int H>
__device__ __forceinline__ void pairwise(float (&w)[32], bool is_sum) {
#pragma unroll
  for (int i = 0; i < H; ++i) w[i] = is_sum ? w[i] + w[i + H] : fmaxf(w[i], w[i + H]);
  if constexpr (H > 1) pairwise<H / 2>(w, is_sum);
}

// Warps of the block that own a slot (thread t owns slots t, t +
// THREADS, ...).
__device__ __forceinline__ int active_warps(int slots) {
  return slots >= THREADS ? WARPS : (slots + 31) / 32;
}

struct Reducer {
  Shared* sh;
  int parity;
  long long barriers;  // block barriers passed (block-uniform)
  // Warps taking part: all of them, or those that own slots once the
  // others have returned. A warp that owns no slot would contribute only
  // the identities (+0 for a sum, -inf for a max), and the second stage
  // pads the missing rows with exactly those, so the results keep their
  // bits.
  int warps;

  __device__ Reducer(Shared& s, int warps_) : sh(&s), parity(0), barriers(0), warps(warps_) {}

  __device__ __forceinline__ void barrier() {
    if (warps == WARPS) {
      __syncthreads();
    } else {
      EG_BAR_SYNC(warps * 32);
    }
    ++barriers;
    parity ^= 1;
  }

  // Sums of the first NS values and maxima of the next NM, over the block;
  // every thread returns with the block-wide results in `v`. The full xor
  // butterfly inside each warp, lane 0's row to shared memory, one
  // barrier, and the butterfly again over the warps' rows.
  template <int NS, int NM>
  __device__ __forceinline__ void reduce(float (&v)[NS + NM]) {
    static_assert(NS + NM <= FUSED_MAX, "too many fused reductions");
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < NS + NM; ++i) {
        float o = __shfl_xor_sync(FULL, v[i], off);
        v[i] = i < NS ? v[i] + o : fmaxf(v[i], o);
      }
    }
    float(*b)[FUSED_MAX] = sh->red[parity].fused;
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < NS + NM; ++i) b[warp][i] = v[i];
    }
    barrier();
#pragma unroll
    for (int i = 0; i < NS + NM; ++i)
      v[i] = lane < warps ? b[lane][i] : (i < NS ? 0.0f : -INFINITY);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < NS + NM; ++i) {
        float o = __shfl_xor_sync(FULL, v[i], off);
        v[i] = i < NS ? v[i] + o : fmaxf(v[i], o);
      }
    }
  }

  // Bit k: whether the block-wide sum of v[k] exceeds `limit`. One value
  // takes the butterfly. More halve recursively inside each warp (lane k
  // ends with value k's warp partial), one row a warp, one barrier; then
  // lane k of every warp combines value k over the warps in the same
  // pairwise order, reading column k of every row (N >= 8) or, with fewer
  // values, lane l reading row l and the rows halved across the lanes. IEEE
  // + is commutative, so every path gives the butterfly's bits, and one
  // ballot hands every thread the whole mask.
  template <int N>
  __device__ __forceinline__ unsigned over(const float (&v)[N], float limit) {
    if constexpr (N == 1) {
      float x[1] = {v[0]};
      reduce<1, 0>(x);
      return x[0] > limit ? 1u : 0u;
    } else {
      static_assert(N <= 32, "at most 32 fused values");
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      float a[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) a[i] = i < N ? v[i] : 0.0f;
      halve<N, N, 16>(a, lane);
      float(*b)[ROW] = sh->red[parity].rows;
      if (lane < N) b[warp][lane] = a[0];
      barrier();
      float r = 0.0f;
      if constexpr (N >= 8) {
        if (lane < N) {
          float w[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) w[i] = i < warps ? b[i][lane] : 0.0f;
          pairwise<16>(w, true);
          r = w[0];
        }
      } else {
        float c[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) c[i] = i < N && lane < warps ? b[lane][i] : 0.0f;
        halve<N, N, 16>(c, lane);
        r = c[0];
      }
      return __ballot_sync(FULL, lane < N && r > limit);
    }
  }

  __device__ __forceinline__ float sum(float x) {
    float v[1] = {x};
    reduce<1, 0>(v);
    return v[0];
  }

  __device__ __forceinline__ float max(float x) {
    float v[1] = {x};
    reduce<0, 1>(v);
    return v[0];
  }
};

// The structure of a kernel's instantiation: a bisection tree of L levels,
// per-job state in shared memory or not. The one-level, global
// instantiation is the sequential structure the others are held to bit
// for bit: one probe a barrier, every bisection run and every reduction
// taken as the sequential code takes it.
template <int L, bool RESIDENT>
struct Config {
  static_assert(L >= 1 && L <= MAX_LEVELS, "1 to MAX_LEVELS levels");
  static constexpr int LEVELS = L;
  static constexpr bool SEQUENTIAL = L == 1 && !RESIDENT;
};

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Midpoint rules of the block-wide bisections.
struct Halve {
  __device__ static __forceinline__ float mid(float lo, float hi) { return 0.5f * (lo + hi); }
};
struct Geometric {
  __device__ static __forceinline__ float mid(float lo, float hi) { return sqrtf(lo * hi); }
};

// `steps` steps of the sequential bisection
//   mid = M::mid(lo, hi); over = sum_j load_j(mid) > limit;
//   lo = over ? mid : lo; hi = over ? hi : mid;
// taken L levels a round. Every thread computes the 2^L - 1 midpoints of
// the next L levels (heap order: node n's children are 2n + 1, not over,
// and 2n + 2, over) with the float operations of the sequential walks
// that reach them, sums its slots' loads at all of them in one fused
// reduction, and follows the mask's path: the bracket after L levels is
// the sequential walk's, bit for bit. `job(j)` returns slot j's load as a
// function of the midpoint.
template <int L, class M, class Job>
__device__ __forceinline__ void bisect(float& lo, float& hi, int steps, float limit, int slots,
                                       Reducer& red, Job job) {
  constexpr int NODES = (1 << L) - 1;
  const int t = threadIdx.x;
  for (int done = 0; done < steps; done += L) {
    float mids[NODES], los[NODES], his[NODES];
    los[0] = lo;
    his[0] = hi;
#pragma unroll
    for (int n = 0; n < NODES; ++n) {
      mids[n] = M::mid(los[n], his[n]);
      if (2 * n + 2 < NODES) {
        los[2 * n + 1] = los[n];
        his[2 * n + 1] = mids[n];
        los[2 * n + 2] = mids[n];
        his[2 * n + 2] = his[n];
      }
    }
    float load[NODES];
#pragma unroll
    for (int n = 0; n < NODES; ++n) load[n] = 0.0f;
    for (int j = t; j < slots; j += THREADS) {
      const auto at = job(j);
#pragma unroll
      for (int n = 0; n < NODES; ++n) load[n] += at(mids[n]);
    }
    const unsigned over = red.template over<NODES>(load, limit);
    const int levels = steps - done < L ? steps - done : L;
    int node = 0;
#pragma unroll
    for (int level = 0; level < L; ++level) {
      if (level < levels) {
        float m = mids[(1 << level) - 1];
#pragma unroll
        for (int n = (1 << level); n < (2 << level) - 1; ++n) m = node == n ? mids[n] : m;
        const bool o = ((over >> node) & 1u) != 0;
        lo = o ? m : lo;
        hi = o ? hi : m;
        node = 2 * node + (o ? 2 : 1);
      }
    }
  }
}

// Euclidean projection of `s` onto {0 <= s <= s_max, w . s <= budget}
// (shockwave_tpu/solver/eg_jax.py::_project, eg_pdhg.py::project_budget):
// 60 bisection steps on the budget row's dual, written to `out` (which may
// be `s`). `wmin` is the least positive weight (inf when none) and
// `max_s_max` the largest cap, both fixed for a problem. Outside the
// sequential structure the bisection is skipped when the clipped point
// fits the budget: the output is then the clipped point either way.
// Returns whether the bisection ran.
template <class K>
__device__ __forceinline__ bool project_budget(const float* s, const float* w, const float* s_max,
                                               float* out, int slots, float budget, float wmin,
                                               float max_s_max, Reducer& red) {
  const int t = threadIdx.x;
  float v[2] = {0.0f, -INFINITY};  // sum w * clip(s), max |s|
  for (int j = t; j < slots; j += THREADS) {
    const float x = s[j];
    v[0] += w[j] * clip(x, 0.0f, s_max[j]);
    v[1] = fmaxf(v[1], fabsf(x));
  }
  red.template reduce<1, 1>(v);
  const bool need = v[0] > budget;
  float lo = 0.0f, hi = (v[1] + max_s_max) / fmaxf(wmin, EPS);
  const bool run = K::SEQUENTIAL || need;
  if (run) {
    bisect<K::LEVELS, Halve>(lo, hi, 60, budget, slots, red, [&](int j) {
      const float x = s[j], wj = w[j], cap = s_max[j];
      return [=](float mid) { return wj * clip(x - mid * wj, 0.0f, cap); };
    });
  }
  const float lam = 0.5f * (lo + hi);
  for (int j = t; j < slots; j += THREADS) {
    const float x = s[j];
    out[j] = need ? clip(x - lam * w[j], 0.0f, s_max[j]) : clip(x, 0.0f, s_max[j]);
  }
  return run;
}

// A probe of the reducers' cost: `iters` fused reductions of N values
// with no per-job work among the first `warps` warps of the block (the
// others return, as a kernel's warps that own no slot do), the sum path
// for N = 1 and the tree's ballot path above. Thread 0 writes a result so
// nothing is elided.
template <int N>
__global__ void __launch_bounds__(THREADS, 1) barrier_probe(float* out, int warps, int iters) {
  __shared__ Shared sh;
  if ((int)(threadIdx.x >> 5) >= warps) return;
  Reducer red(sh, warps);
  float acc = 0.0f;
  for (int it = 0; it < iters; ++it) {
    float v[N];
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = (float)((threadIdx.x + k + it) & 7);
    if (N == 1) {
      acc += red.sum(v[0]);
    } else {
      acc += (float)(red.template over<N>(v, 3.5f * THREADS) & 1u);
    }
  }
  if (threadIdx.x == 0) out[0] = acc;
}

}  // namespace eg
