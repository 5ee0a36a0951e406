// Runs one planning kernel's block on the host (cuda_runtime.h here):
//   run_kernel <packed.bin> <out.bin> <rows> <slots> <arg> [<arg>]
// reads one packed problem ([rows][slots] float32), runs the kernel with
// EG_THREADS threads, and writes the output row and the barrier count.
// Build with -DKERNEL_SOURCE=\"<path to eg_pdhg.cu or eg_relaxed.cu>\"
// and -DKERNEL_PDHG for kernel A.
#include "cuda_runtime.h"

#include <cstdio>
#include <cstdlib>
#include <thread>

thread_local HostDim3 threadIdx;
HostDim3 blockIdx;
std::barrier<>* host_block_barrier;
std::vector<std::barrier<>*> host_warp_barriers;
float host_shuffle[1024];

#include KERNEL_SOURCE

int main(int argc, char** argv) {
  if (argc < 6) return 2;
  const int rows = atoi(argv[3]), slots = atoi(argv[4]), a = atoi(argv[5]);
  const int b = argc > 6 ? atoi(argv[6]) : 0;
  std::vector<float> in((size_t)rows * slots), scratch((size_t)SCRATCH * slots),
      out(slots + DIAG);
  FILE* f = fopen(argv[1], "rb");
  if (!f || fread(in.data(), 4, in.size(), f) != in.size()) return 3;
  fclose(f);
  long long barriers = 0;
  host_block_barrier = new std::barrier<>(eg::THREADS);
  for (int w = 0; w < eg::WARPS; ++w) host_warp_barriers.push_back(new std::barrier<>(32));
  std::vector<std::thread> threads;
  for (int t = 0; t < eg::THREADS; ++t) {
    threads.emplace_back([&, t] {
      threadIdx.x = t;
#ifdef KERNEL_PDHG
      pdhg_kernel(in.data(), scratch.data(), out.data(), &barriers, slots, a, b);
#else
      relaxed_kernel(in.data(), scratch.data(), out.data(), &barriers, slots, a);
#endif
    });
  }
  for (auto& t : threads) t.join();
  f = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), f);
  fwrite(&barriers, 8, 1, f);
  fclose(f);
  return 0;
}
