// Shared pieces of the one-block-per-problem planning kernels
// (eg_pdhg.cu, eg_relaxed.cu): the block shape, the deterministic block
// reductions and the budget projection both solvers run.
//
// A problem's job axis is padded to `slots` and owned by one block of
// THREADS threads: thread t owns slots t, t + THREADS, ... for the whole
// solve. Every per-job update reads and writes only the slots its thread
// owns, so per-job scratch in global memory needs no barrier between a
// write and the next read; only the global reductions synchronise.
//
// Reductions are deterministic: each thread sums (or takes the max of)
// its own slots in ascending order, a warp combines its 32 partials with a
// fixed xor butterfly (every lane ends with bit-identical values), lane 0
// of each warp writes its result to shared memory, one __syncthreads, and
// every warp combines the 32 warp results with the same butterfly. No
// atomics, so two runs give bit-identical results. Shared memory is
// double-buffered: reduction n+1 writes the other buffer, and reduction
// n+2 may only reuse this one after every thread has passed reduction
// n+1's barrier, which it reaches after reading reduction n's results.
// So a reduction of up to MAX_FUSED values costs one block barrier.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
constexpr int MAX_FUSED = 6;
constexpr float EPS = 1e-6f;

struct Reducer {
  float (*buf)[WARPS][MAX_FUSED];  // shared [2][WARPS][MAX_FUSED]
  int parity;
  long long barriers;  // block barriers passed (block-uniform)

  // Sums of the first NS values and maxima of the next NM, over the block;
  // every thread returns with the block-wide results in `v`.
  template <int NS, int NM>
  __device__ __forceinline__ void reduce(float (&v)[NS + NM]) {
    static_assert(NS + NM <= MAX_FUSED, "too many fused reductions");
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < NS + NM; ++i) {
        float o = __shfl_xor_sync(0xffffffffu, v[i], off);
        v[i] = i < NS ? v[i] + o : fmaxf(v[i], o);
      }
    }
    float(*b)[MAX_FUSED] = buf[parity];
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < NS + NM; ++i) b[warp][i] = v[i];
    }
    __syncthreads();
    ++barriers;
    parity ^= 1;
#pragma unroll
    for (int i = 0; i < NS + NM; ++i) v[i] = lane < WARPS ? b[lane][i] : (i < NS ? 0.0f : -INFINITY);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < NS + NM; ++i) {
        float o = __shfl_xor_sync(0xffffffffu, v[i], off);
        v[i] = i < NS ? v[i] + o : fmaxf(v[i], o);
      }
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

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Euclidean projection of `s` onto {0 <= s <= s_max, w . s <= budget}
// (shockwave_tpu/solver/eg_jax.py::_project, eg_pdhg.py::project_budget):
// 60 bisection steps on the budget row's dual, written to `out` (which may
// be `s`). `wmin` is the least positive weight (inf when none) and
// `max_s_max` the largest cap, both fixed for a problem.
__device__ __forceinline__ void project_budget(const float* s, const float* w,
                                               const float* s_max, float* out, int slots,
                                               float budget, float wmin, float max_s_max,
                                               Reducer& red) {
  const int t = threadIdx.x;
  float v[2] = {0.0f, -INFINITY};  // sum w * clip(s), max |s|
  for (int j = t; j < slots; j += THREADS) {
    const float x = s[j];
    v[0] += w[j] * clip(x, 0.0f, s_max[j]);
    v[1] = fmaxf(v[1], fabsf(x));
  }
  red.reduce<1, 1>(v);
  const bool need = v[0] > budget;
  float lo = 0.0f, hi = (v[1] + max_s_max) / fmaxf(wmin, EPS);
  for (int it = 0; it < 60; ++it) {
    const float mid = 0.5f * (lo + hi);
    float load = 0.0f;
    for (int j = t; j < slots; j += THREADS) load += w[j] * clip(s[j] - mid * w[j], 0.0f, s_max[j]);
    const bool over = red.sum(load) > budget;
    lo = over ? mid : lo;
    hi = over ? hi : mid;
  }
  const float lam = 0.5f * (lo + hi);
  for (int j = t; j < slots; j += THREADS) {
    const float x = s[j];
    out[j] = need ? clip(x - lam * w[j], 0.0f, s_max[j]) : clip(x, 0.0f, s_max[j]);
  }
}

}  // namespace eg
