#include <cstdio>

#include "warp_emu.h"
thread_local Dim threadIdx, blockIdx;
thread_local EmuBlock* emu_blk;
std::atomic<int> emu_faults{0};
extern "C" int emu_fault_count() { return emu_faults.load(); }
int emu_launch(int grid, int block, size_t smem, std::function<void()> fn) {
  if (block != 32) { emu_faults++; return 1; }
  for (int g = 0; g < grid; ++g) {
    EmuBlock b;
    std::vector<unsigned char> mem(smem + 64, 0xCD);
    b.smem = mem.data();
    std::vector<std::thread> th;
    for (int t = 0; t < 32; ++t) {
      b.nsync[t] = 0;
      th.emplace_back([&, t, g] {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {(unsigned)g, 0, 0};
        emu_blk = &b;
        fn();
        b.bar.arrive_and_drop();
      });
    }
    for (auto& x : th) x.join();
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
