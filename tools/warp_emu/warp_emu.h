// Host emulation of the CUDA subset the port's lane scans use (see
// tools/warp_emu/__init__.py): one block at a time, 32 std::threads per
// block, every warp-wide primitive a barrier over the 32.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <functional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(x) alignas(x)
#define __restrict__ __restrict

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned x, unsigned y) { return uint2{x, y}; }
struct int2 { int x, y; };
inline int2 make_int2(int x, int y) { return int2{x, y}; }
struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }
struct Dim { unsigned x, y, z; };
extern thread_local Dim threadIdx, blockIdx;

struct EmuBlock {
  std::barrier<> bar{32};
  long long slots[32];
  unsigned char* smem;
  long long nsync[32];
};
extern thread_local EmuBlock* emu_blk;

template <class F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int min(int a, int b) { return a < b ? a : b; }
template <class T> inline T __ldg(const T* p) { return *p; }
// byte n of the result is byte (s >> 4n) & 7 of the pair {y, x}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long v = (unsigned long long)y << 32 | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n)
    r |= (unsigned)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n);
  return r;
}
inline int max(int a, int b) { return a > b ? a : b; }
// the upper 32 bits of hi:lo shifted left by s & 31
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned s) {
  const unsigned long long v = (unsigned long long)hi << 32 | lo;
  return (unsigned)((v << (s & 31)) >> 32);
}
// the word's old value; the OR is atomic among the block's threads
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_or(v);
}

inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_blk->nsync[threadIdx.x]++;
  emu_blk->bar.arrive_and_wait();
}
// every thread t publishes v and takes the value of thread src(t)
template <class T, class F> inline T emu_exchange(T v, F src) {
  EmuBlock* b = emu_blk;
  const int t = threadIdx.x;
  b->nsync[t]++;
  b->slots[t] = (long long)v;
  b->bar.arrive_and_wait();
  T r = (T)b->slots[src(t)];
  b->bar.arrive_and_wait();
  return r;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
  return emu_exchange(v, [&](int) { return src & 31; });
}
// the value of thread t - d, or the thread's own below d
template <class T> inline T __shfl_up_sync(unsigned, T v, unsigned d) {
  return emu_exchange(v, [&](int t) { return t >= (int)d ? t - (int)d : t; });
}
// the value of thread t ^ m
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m) {
  return emu_exchange(v, [&](int t) { return (t ^ m) & 31; });
}
inline unsigned __ballot_sync(unsigned, int p) {
  EmuBlock* b = emu_blk;
  b->nsync[threadIdx.x]++;
  b->slots[threadIdx.x] = p ? 1 : 0;
  b->bar.arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (b->slots[i] ? 1u : 0u) << i;
  b->bar.arrive_and_wait();
  return m;
}

int emu_launch(int grid, int block, size_t smem, std::function<void()> fn);
