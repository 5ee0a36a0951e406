// Host stand-in for the CUDA runtime and builtins the planning kernels
// (shockwave_tpu_torch/ops/csrc/eg_*.cu) use, so that their C++ compiles
// with a host compiler and one thread block runs on the host. The block's
// THREADS threads are fibers (ucontext) on one OS thread, switched in
// round robin whenever one waits: __syncthreads is a block-wide barrier,
// and a warp shuffle or ballot goes through a per-warp buffer behind one
// warp-wide barrier (two buffers taken in turns, so a lane never
// overwrites a value another lane has yet to read); `bar.sync 1, count`
// is a barrier of `count` fibers. Used by
// tests/test_torch_eg_kernels_host.py; the kernels' numerics on a card
// are checked by chip_smoke.py.
#pragma once
#include <ucontext.h>

#include <cmath>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(threads, blocks)
#define __restrict__

struct HostDim3 {
  int x = 0, y = 0, z = 0;
};
// The running fiber's index; the scheduler sets it at every switch.
extern HostDim3 threadIdx;
extern HostDim3 blockIdx;

struct float4 {
  float x, y, z, w;
};

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

// The block's dynamic shared memory: one buffer the runner allocates.
extern float* host_dynamic_shared;
#define EG_DYNAMIC_SHARED(name) float* name = host_dynamic_shared

struct HostFiber {
  ucontext_t context;
  std::vector<char> stack;
  bool done = false;
};
extern std::vector<HostFiber> host_fibers;

// Switch to the next fiber that has not finished.
inline void host_yield() {
  const int n = (int)host_fibers.size(), self = threadIdx.x;
  int next = (self + 1) % n;
  while (host_fibers[next].done && next != self) next = (next + 1) % n;
  if (next == self) return;
  threadIdx.x = next;
  swapcontext(&host_fibers[self].context, &host_fibers[next].context);
}

struct HostBarrier {
  int count = 0, arrived = 0;
  long long generation = 0;
  void arrive_and_wait() {
    const long long g = generation;
    if (++arrived == count) {
      arrived = 0;
      ++generation;
      return;
    }
    while (generation == g) host_yield();
  }
};
extern HostBarrier host_block_barrier, host_named_barrier;
extern std::vector<HostBarrier> host_warp_barriers;
extern float host_shuffle[2][1024];
extern int host_vote[2][1024];
extern int host_turn[1024];

inline void __syncthreads() { host_block_barrier.arrive_and_wait(); }
// bar.sync 1, count: the fibers still running that call it, `count` in all.
inline void host_bar_sync(int count) {
  host_named_barrier.count = count;
  host_named_barrier.arrive_and_wait();
}
#define EG_BAR_SYNC(count) host_bar_sync(count)
inline void __syncwarp() { host_warp_barriers[threadIdx.x >> 5].arrive_and_wait(); }

inline float host_exchange(float v, int src_lane) {
  const int t = threadIdx.x, warp = t >> 5, turn = host_turn[t] ^= 1;
  host_shuffle[turn][t] = v;
  host_warp_barriers[warp].arrive_and_wait();
  return host_shuffle[turn][(warp << 5) | (src_lane & 31)];
}

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  return host_exchange(v, (threadIdx.x & 31) ^ lane_mask);
}

inline float __shfl_sync(unsigned, float v, int src_lane) { return host_exchange(v, src_lane); }

inline unsigned __ballot_sync(unsigned, bool pred) {
  const int t = threadIdx.x, warp = t >> 5, turn = host_turn[t] ^= 1;
  host_vote[turn][t] = pred ? 1 : 0;
  host_warp_barriers[warp].arrive_and_wait();
  unsigned mask = 0;
  for (int lane = 0; lane < 32; ++lane) mask |= (unsigned)host_vote[turn][(warp << 5) | lane] << lane;
  return mask;
}
