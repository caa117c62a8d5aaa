// Latency of one dependent range-coder decision on one warp: the
// yardstick for the chain bound of the lane-scan kernels (K1, K2 and
// their extended forms), which run one warp per slice lane and can go no
// faster than (serial decisions of the longest lane) x (this latency).
//
// Not a port of a TPU kernel and not on the codec's path: chip_smoke.py
// launches it once per mode on a single warp and times it with CUDA
// events.  Each iteration is the part of a decision the next one waits
// on, in the kernels' own instructions:
//   mode 0 (encode, as K1): r1 = range * state >> 8, the bit's split of
//     low/range, and the one-step renormalisation; the state comes by
//     shuffle from its owner thread and the bit from a fixed pattern,
//     neither of which waits on the chain;
//   mode 1 (decode, as K2): the same split decided by low >= range - r1,
//     and the refill byte read by shuffle at the chain's own position.
// The final coder state is written out so nothing is optimised away.
// Each mode is its own kernel instance, so chip_smoke.py can count the
// SASS instructions of one decision in it (cuobjdump -sass: the main
// loop's instructions over the decisions it unrolls, one shuffle each
// in mode 0, two in mode 1) for the operations term of the kernels'
// roofline bound.
//
// row_probe_kernel is the yardstick of the table-in-global-memory forms
// (context model 1), whose decode chain waits on each pixel's 32-byte state
// row: the latency of one dependent row read from L2 on one warp.  Thread t
// loads byte t of the row with ld.global.cg (from L2: the kernels' plain
// loads may also hit L1, which this probe leaves out), and the next row's
// index comes by shuffle from bytes 0 and 1; the table is one random cycle over its rows (chip_smoke.py builds
// it, 484,032 B as one lane's context-model-1 table), so each read waits on
// the one before.
//
// smem_probe_kernel is the shared-memory counterpart, and the port of the
// TPU lookup probes (scripts/probes/gather_probe.py:59,90,
// gather_probe2.py:79,90, gather_probe3.py:40, gather_probe4.py:54,
// read_probe.py:99,109), which timed a dependent per-lane lookup in a
// VMEM table under each lowering Mosaic offered.  On Hopper the lane
// scans do these lookups in shared memory, one way each:
//   mode 0 (row): one 32-byte state row read from a table of `rows` rows
//     staged in shared memory (1,332 rows = 42,624 B, context model 0's
//     table in K1 and K2); thread t reads byte t and the next row's index
//     comes by shuffle from bytes 0 and 1, as in row_probe_kernel;
//   mode 1 (byte): the transition lookup of K1's adaptation, each thread
//     s = tab[s] in a 256-entry table in shared memory, dependent on the
//     thread's own previous result.
// Both keep a running sum so that the plain loop in
// tpu_ffv1_torch/kernels/probes.py can check the final index and sum.
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

template <int MODE>
__global__ void __launch_bounds__(32) chain_probe_kernel(
    const uint8_t* __restrict__ states, const uint8_t* __restrict__ bytes,
    int n, int32_t* __restrict__ out) {
  const int t = threadIdx.x;
  const int mys = max((int)states[t], 1);
  const int myb = bytes[t];
  const uint32_t pattern = 0x9E3779B9u;
  int low = 0, rng = 0xFF00, pos = 0;
  if (MODE == 0) {
    for (int i = 0; i < n; ++i) {
      const int s = __shfl_sync(FULL_MASK, mys, i & 31);
      const int b = (pattern >> (i & 31)) & 1;
      const int r1 = (rng * s) >> 8;
      int nr = b ? r1 : rng - r1;
      int nl = low + (b ? rng - r1 : 0);
      if (nr < 0x100) {
        nl = (nl & 0xFF) << 8;
        nr <<= 8;
      }
      low = nl;
      rng = nr;
    }
  } else {
    low = 0x1234;
    for (int i = 0; i < n; ++i) {
      const int s = __shfl_sync(FULL_MASK, mys, i & 31);
      const int nxt = __shfl_sync(FULL_MASK, myb, pos & 31);
      const int r1 = (rng * s) >> 8;
      const int r0 = rng - r1;
      if (low >= r0) {
        low -= r0;
        rng = r1;
      } else {
        rng = r0;
      }
      if (rng < 0x100) {
        low = (low << 8) + nxt;
        rng <<= 8;
        ++pos;
      }
    }
  }
  if (t == 0) {
    out[0] = low;
    out[1] = rng;
    out[2] = pos;
  }
}

__global__ void __launch_bounds__(32) row_probe_kernel(
    const uint8_t* __restrict__ table, int n, int32_t* __restrict__ out) {
  const int t = threadIdx.x;
  int r = 0, acc = 0;
  for (int i = 0; i < n; ++i) {
    const int b = __ldcg(table + (size_t)r * 32 + t);
    acc += b;
    r = __shfl_sync(FULL_MASK, b, 0) | (__shfl_sync(FULL_MASK, b, 1) << 8);
  }
  if (t == 0) {
    out[0] = r;
    out[1] = acc;
  }
}

template <int MODE>
__global__ void __launch_bounds__(32) smem_probe_kernel(
    const uint8_t* __restrict__ table, int rows, int n,
    int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t tab[];
  const int t = threadIdx.x;
  const int nbytes = MODE == 0 ? rows * 32 : 256;
  for (int i = t; i < nbytes; i += 32) tab[i] = table[i];
  __syncwarp();
  int r = MODE == 0 ? 0 : t, acc = 0;
  for (int i = 0; i < n; ++i) {
    if (MODE == 0) {
      const int b = tab[r * 32 + t];
      acc += b;
      r = __shfl_sync(FULL_MASK, b, 0) | (__shfl_sync(FULL_MASK, b, 1) << 8);
    } else {
      r = tab[r];
      acc += r;
    }
  }
  out[2 * t] = r;
  out[2 * t + 1] = acc;
}

// Plain C entry point of the shared-memory probes (mode 0 row, 1 byte):
// the cudaError_t of the launch.  out holds (index, sum) per thread.
extern "C" int smem_probe_launch(const void* table, int rows, int n,
                                 int mode, void* out, void* stream) {
  const size_t smem = mode == 0 ? (size_t)rows * 32 : 256;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (mode == 0) {
    smem_probe_kernel<0><<<1, 32, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)table, rows, n, (int32_t*)out);
  } else {
    smem_probe_kernel<1><<<1, 32, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)table, rows, n, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

// Plain C entry point of the row probe: the cudaError_t of the launch.
extern "C" int row_probe_launch(const void* table, int n, void* out,
                                void* stream) {
  row_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)table, n, (int32_t*)out);
  return (int)cudaGetLastError();
}

// Plain C entry point: returns the cudaError_t of the launch (0 = ok).
extern "C" int chain_probe_launch(const void* states, const void* bytes,
                                  int n, int mode, void* out,
                                  void* stream) {
  if (mode == 0) {
    chain_probe_kernel<0><<<1, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)states, (const uint8_t*)bytes, n, (int32_t*)out);
  } else {
    chain_probe_kernel<1><<<1, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)states, (const uint8_t*)bytes, n, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
