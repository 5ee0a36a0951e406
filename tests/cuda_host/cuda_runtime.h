// Host stand-in for the CUDA runtime and builtins the planning kernels
// (shockwave_tpu_torch/ops/csrc/eg_*.cu) use, so that their C++ compiles
// with a host compiler and one thread block runs as THREADS std::threads:
// __syncthreads is a block-wide std::barrier, and a warp shuffle goes
// through a per-warp buffer between two warp-wide barriers. Used by
// tests/test_torch_eg_kernels_host.py; the kernels' numerics on a card
// are checked by chip_smoke.py.
#pragma once
#include <barrier>
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
extern thread_local HostDim3 threadIdx;
extern HostDim3 blockIdx;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

extern std::barrier<>* host_block_barrier;
extern std::vector<std::barrier<>*> host_warp_barriers;
extern float host_shuffle[1024];

inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int t = threadIdx.x, warp = t >> 5;
  host_shuffle[t] = v;
  host_warp_barriers[warp]->arrive_and_wait();
  const float other = host_shuffle[(warp << 5) | ((t & 31) ^ lane_mask)];
  host_warp_barriers[warp]->arrive_and_wait();
  return other;
}
