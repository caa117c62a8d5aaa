// Host emulation of the CUDA subset the port's lane scans use (see
// tools/warp_emu/__init__.py): one block at a time, its 32 threads as
// coroutines on one host thread, every warp-wide primitive the point
// where a thread hands its turn to the next.
#pragma once
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
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
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaDevAttrMultiProcessorCount = 16 };
struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned x, unsigned y) { return uint2{x, y}; }
struct int2 { int x, y; };
inline int2 make_int2(int x, int y) { return int2{x, y}; }
struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }
struct Dim { unsigned x, y, z; };
extern thread_local Dim threadIdx, blockIdx, gridDim;

struct EmuBlock {
  // each primitive's values, by the parity of the thread's primitive count
  // (a thread that has passed primitive k can publish k + 1 before the
  // others have read k, never k + 2)
  long long slots[2][32];
  unsigned char* smem;
  long long nsync[32];
};
extern thread_local EmuBlock* emu_blk;
// hand the emulated thread's turn to the next one; back when all 32 have
// reached their next warp primitive (or ended)
void emu_yield();

template <class F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
// the emulated card has 2 SMs, so a kernel that sizes its grid by the
// SM count walks a few thousand pixels with a grid stride
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 2; return 0; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
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
// the word's old value; the sum is atomic among the block's threads
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
// double arithmetic rounded once to nearest (the host compiles these
// without FMA contraction: x86-64 with no -march)
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }

inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_blk->nsync[threadIdx.x]++;
  emu_yield();
}
// every thread t publishes v and takes the value of thread src(t)
template <class T, class F> inline T emu_exchange(T v, F src) {
  EmuBlock* b = emu_blk;
  const int t = threadIdx.x;
  long long* slot = b->slots[b->nsync[t]++ & 1];
  slot[t] = (long long)v;
  emu_yield();
  return (T)slot[src(t)];
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
  const int t = threadIdx.x;
  long long* slot = b->slots[b->nsync[t]++ & 1];
  slot[t] = p ? 1 : 0;
  emu_yield();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (slot[i] ? 1u : 0u) << i;
  return m;
}

int emu_launch(int grid, int block, size_t smem, std::function<void()> fn);
