// Runs one planning kernel's block on the host (cuda_runtime.h here):
//   run_kernel <packed.bin> <out.bin> <rows> <slots> <levels> <resident>
//              <arg> [<arg>]
// reads one packed problem ([rows][slots] float32), runs the kernel's C
// entry point (eg_pdhg or eg_relaxed) with EG_THREADS threads for the
// instantiation of `levels` levels, state in shared memory or not, and
// writes the output row and the stats row (4 int64). Build with
// -DKERNEL_SOURCE=\"<path to eg_pdhg.cu or eg_relaxed.cu>\" and
// -DKERNEL_PDHG for kernel A.
#include "cuda_runtime.h"

#include <cstdio>
#include <cstdlib>
#include <functional>

HostDim3 threadIdx;
HostDim3 blockIdx;
float* host_dynamic_shared;
std::vector<HostFiber> host_fibers;
HostBarrier host_block_barrier, host_named_barrier;
std::vector<HostBarrier> host_warp_barriers;
float host_shuffle[2][1024];
int host_vote[2][1024];
int host_turn[1024];

#include KERNEL_SOURCE

static std::function<void()> host_body;
static ucontext_t host_main;

static void host_fiber_entry() {
  host_body();
  host_fibers[threadIdx.x].done = true;
  // Back to the scheduler (uc_link), which resumes whoever is left.
}

// Runs `body` as eg::THREADS fibers to the end of the block.
static void host_run_block(std::function<void()> body) {
  host_body = std::move(body);
  host_fibers = std::vector<HostFiber>(eg::THREADS);
  host_block_barrier.count = eg::THREADS;
  host_warp_barriers = std::vector<HostBarrier>(eg::WARPS);
  for (auto& b : host_warp_barriers) b.count = 32;
  for (auto& f : host_fibers) {
    f.stack.resize(1 << 18);
    getcontext(&f.context);
    f.context.uc_stack.ss_sp = f.stack.data();
    f.context.uc_stack.ss_size = f.stack.size();
    f.context.uc_link = &host_main;
    makecontext(&f.context, host_fiber_entry, 0);
  }
  for (;;) {
    int next = 0;
    while (next < eg::THREADS && host_fibers[next].done) ++next;
    if (next == eg::THREADS) break;
    threadIdx.x = next;
    swapcontext(&host_main, &host_fibers[next].context);
  }
}

int main(int argc, char** argv) {
  if (argc < 8) return 2;
  const int rows = atoi(argv[3]), slots = atoi(argv[4]), levels = atoi(argv[5]),
            resident = atoi(argv[6]), a = atoi(argv[7]);
  const int b = argc > 8 ? atoi(argv[8]) : 0;
#ifdef KERNEL_PDHG
  const int state = eg_pdhg_state_floats(slots), shared = eg_pdhg_shared_bytes(slots);
#else
  const int state = eg_relaxed_state_floats(slots), shared = eg_relaxed_shared_bytes(slots);
#endif
  std::vector<float> in((size_t)rows * slots), scratch(state), dynamic(shared / 4),
      out(slots + DIAG);
  std::vector<long long> stats(STATS, -1);
  std::vector<int> codes(eg::THREADS, -1);
  host_dynamic_shared = dynamic.data();
  FILE* f = fopen(argv[1], "rb");
  if (!f || fread(in.data(), 4, in.size(), f) != in.size()) return 3;
  fclose(f);
  host_run_block([&] {
    const int t = threadIdx.x;
#ifdef KERNEL_PDHG
    codes[t] = eg_pdhg(in.data(), resident ? nullptr : scratch.data(), out.data(), stats.data(),
                       1, slots, a, b, levels, resident, nullptr);
#else
    codes[t] = eg_relaxed(in.data(), resident ? nullptr : scratch.data(), out.data(),
                          stats.data(), 1, slots, a, levels, resident, nullptr);
#endif
  });
  for (int code : codes)
    if (code != 0) return 4;
  f = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), f);
  fwrite(stats.data(), 8, stats.size(), f);
  fclose(f);
  return 0;
}
