#include <ucontext.h>

#include <cstdio>
#include <vector>

#include "warp_emu.h"
thread_local Dim threadIdx, blockIdx, gridDim;
thread_local EmuBlock* emu_blk;
std::atomic<int> emu_faults{0};
extern "C" int emu_fault_count() { return emu_faults.load(); }

// the running block's coroutines: the scheduler's context and each
// thread's, and which threads have ended
namespace {
thread_local ucontext_t* emu_sched;
thread_local ucontext_t* emu_ctx;
thread_local const std::function<void()>* emu_fn;
thread_local bool* emu_done;
constexpr size_t STACK = 1 << 20;

void emu_entry() {
  (*emu_fn)();
  emu_done[threadIdx.x] = true;
  // returns to uc_link, the scheduler
}
}  // namespace

void emu_yield() {
  swapcontext(&emu_ctx[threadIdx.x], emu_sched);
}

int emu_launch(int grid, int block, size_t smem, std::function<void()> fn) {
  if (block != 32) { emu_faults++; return 1; }
  std::vector<char> stacks(32 * STACK);
  ucontext_t sched, ctx[32];
  bool done[32];
  emu_sched = &sched;
  emu_ctx = ctx;
  emu_fn = &fn;
  emu_done = done;
  for (int g = 0; g < grid; ++g) {
    EmuBlock b;
    std::vector<unsigned char> mem(smem + 64, 0xCD);
    b.smem = mem.data();
    emu_blk = &b;
    blockIdx = {(unsigned)g, 0, 0};
    gridDim = {(unsigned)grid, 0, 0};
    for (int t = 0; t < 32; ++t) {
      b.nsync[t] = 0;
      done[t] = false;
      getcontext(&ctx[t]);
      ctx[t].uc_stack.ss_sp = stacks.data() + t * STACK;
      ctx[t].uc_stack.ss_size = STACK;
      ctx[t].uc_link = &sched;
      makecontext(&ctx[t], emu_entry, 0);
    }
    // rounds: each thread runs to its next warp primitive, in order; a
    // primitive's values are all published before any thread reads them
    for (bool live = true; live;) {
      live = false;
      for (int t = 0; t < 32; ++t) {
        if (done[t]) continue;
        threadIdx = {(unsigned)t, 0, 0};
        swapcontext(&sched, &ctx[t]);
        live |= !done[t];
      }
    }
    for (int t = 1; t < 32; ++t)
      if (b.nsync[t] != b.nsync[0]) {
        std::fprintf(stderr, "emu: block %d thread %d made %lld warp syncs, "
                     "thread 0 %lld\n", g, t, b.nsync[t], b.nsync[0]);
        emu_faults++;
        break;
      }
  }
  return 0;
}
