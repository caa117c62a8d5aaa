// Latency of one VLC-coded pixel's dependent step on one warp: the
// yardstick for the chain bound of the Golomb-Rice lane scans (G1,
// golomb_encode.cu; G2, golomb_decode.cu), which run one warp per slice lane
// and can go no faster than (VLC-coded pixels of the longest lane) x (this
// latency).
//
// Not a port of a TPU kernel and not on the codec's path: chip_smoke.py
// launches it once per mode on a single warp, times it with CUDA events and
// holds its result against the plain loop (tpu_ffv1_torch/kernels/probes.py
// golomb_step_ref).  Each iteration is one pixel outside a run, in the
// kernels' own instructions and order: the VlcState row read from a table in
// shared memory, k, the code, the row's update (golomb_vlc.cuh) and its store
// back, before which the next pixel's row read cannot issue (the warp issues
// in order, and the next row may be this one):
//   mode 0 (encode, as G1): the residual folded under the row's bias, the
//     sign flip by the drift, and the code's bits packed MSB first into the
//     64-bit accumulator, whole bytes into a 512-byte ring in shared memory;
//     the pixel's context and residual come from a 32-entry array in shared
//     memory, neither waiting on the chain;
//   mode 1 (decode, as G2): the context from the row-parallel part plus the
//     quantized L - LT of the pixel before, the code read at the bit position
//     from a 512-byte ring of random bytes (the unary prefix by a leading-zero
//     count, the escape), the residual, the median prediction from L, T and
//     LT, and the sample; the next pixel's context waits on it, and its bit
//     window on the position this code ended at.
// The pixel loop is not unrolled, so chip_smoke.py can count its SASS
// instructions (cuobjdump -sass) for the operations term of G1's and G2's
// roofline bound.  Shared memory: the table (rows x 16 B), the 32 pixels'
// inputs, one quant table and the ring.
#include <cuda_runtime.h>
#include <stdint.h>

#include "golomb_vlc.cuh"  // vlc_k, update_vlc

enum : int { RING = 512, BITS = 8 };

template <int MODE>
__global__ void __launch_bounds__(32) golomb_step_kernel(
    const int32_t* __restrict__ vlc0, int rows,
    const int32_t* __restrict__ pix, const uint8_t* __restrict__ bytes,
    const int32_t* __restrict__ qt, int n, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  int4* st = reinterpret_cast<int4*>(smem);
  int2* px = reinterpret_cast<int2*>(st + rows);
  int32_t* qt_s = reinterpret_cast<int32_t*>(px + 32);
  uint8_t* ring = reinterpret_cast<uint8_t*>(qt_s + 256);
  const int t = threadIdx.x;
  for (int i = t; i < rows; i += 32)
    st[i] = reinterpret_cast<const int4*>(vlc0)[i];
  px[t] = make_int2(pix[2 * t], pix[2 * t + 1]);
  for (int i = t; i < 256; i += 32) qt_s[i] = qt[i];
  for (int i = t; i < RING; i += 32) ring[i] = MODE == 0 ? 0 : bytes[i];
  const int mask_v = (1 << BITS) - 1, half = 1 << (BITS - 1);
  __syncwarp();
  int s0 = 0, s1 = 0, s2 = 0;    // the chain's state, written out
  if (MODE == 0) {
    int nbytes = 0;
    unsigned long long acc = 0;
    int nacc = 0;
    auto put = [&](int nb, unsigned v) {
      acc = (acc << nb) | v;
      nacc += nb;
      while (nacc >= 8) {
        nacc -= 8;
        ring[nbytes & (RING - 1)] = (uint8_t)(acc >> nacc);
        ++nbytes;
      }
      acc &= (1ull << nacc) - 1;
    };
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int2 p = px[i & 31];               // (context, residual)
      int4* rowp = st + p.x;
      const int4 row = *rowp;
      const int vf = ((p.y - row.z + half) & mask_v) - half;
      const int k = vlc_k(row.w, row.y);
      const int code = 2 * row.x + row.w < 0 ? ~vf : vf;
      const int code2 = code >= 0 ? 2 * code : -2 * code - 1;
      if ((code2 >> k) >= 12)
        put(12 + BITS, (unsigned)(code2 - 11));
      else
        put((code2 >> k) + k + 1,
            (1u << k) + (unsigned)(code2 & ((1 << k) - 1)));
      const int4 nrow = update_vlc(row, vf);
      __syncwarp();
      *rowp = nrow;
    }
    s0 = nbytes;
    s1 = nacc;
    s2 = (int)acc;
  } else {
    int bp = 0, Lv = 0, LT = 0;
    auto peek = [&](int q) -> uint32_t {
      const int b = q >> 3;
      unsigned long long w = 0;
#pragma unroll
      for (int k = 0; k < 5; ++k) w = (w << 8) | ring[(b + k) & (RING - 1)];
      return (uint32_t)(w >> (8 - (q & 7)));
    };
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int2 tc = px[i & 31];              // (T, context part)
      const int T = tc.x;
      int ctx = tc.y + qt_s[(Lv - LT) & 0xFF];
      const bool csign = ctx < 0;
      if (csign) ctx = -ctx;
      int4* rowp = st + min(ctx, rows - 1);
      const int4 row = *rowp;
      const int k = vlc_k(row.w, row.y);
      const uint32_t w32 = peek(bp);
      const int e = __clz((int)w32);
      int v;
      if (e >= 12) {
        v = (int)((w32 >> (20 - BITS)) & mask_v) + 11;
        bp += 12 + BITS;
      } else {
        const int nb = e + 1 + k;
        v = (e << k) | (int)((w32 >> (32 - nb)) & ((1u << k) - 1));
        bp += nb;
      }
      int sv = (v >> 1) ^ -(v & 1);
      if (2 * row.x + row.w < 0) sv = ~sv;
      int diff = ((sv + row.z + half) & mask_v) - half;
      const int4 nrow = update_vlc(row, sv);
      __syncwarp();
      *rowp = nrow;
      if (csign) diff = -diff;
      const int m = Lv + T - LT;
      const int pred = Lv + m + T - min(min(Lv, m), T) - max(max(Lv, m), T);
      LT = T;
      Lv = (pred + diff) & mask_v;
    }
    s0 = bp;
    s1 = Lv;
    s2 = LT;
  }
  __syncwarp();
  if (t == 0) {
    out[0] = s0;
    out[1] = s1;
    out[2] = s2;
    out[3] = 0;
  }
  int4* tab = reinterpret_cast<int4*>(out + 4);
  for (int i = t; i < rows; i += 32) tab[i] = st[i];
  for (int i = t; i < RING; i += 32) out[4 + 4 * rows + i] = ring[i];
}

// Plain C entry point: returns the cudaError_t of the launch (0 = ok).  vlc0
// is int32 (rows, 4), pix int32 (32, 2) (mode 0: context < rows, residual;
// mode 1: T, context part), bytes uint8 (512,) (mode 1), qt int32 (256,);
// out int32 (4 + 4 * rows + 512,): the chain's state (mode 0: bytes, pending
// bits, the accumulator; mode 1: bit position, L, LT), the table, the ring.
extern "C" int golomb_step_launch(const void* vlc0, int rows, const void* pix,
                                  const void* bytes, const void* qt, int n,
                                  int mode, void* out, void* stream) {
  const size_t smem = (size_t)rows * 16 + 32 * 8 + 256 * 4 + RING;
  if (rows < 1 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) {
    golomb_step_kernel<0><<<1, 32, smem, s>>>(
        (const int32_t*)vlc0, rows, (const int32_t*)pix,
        (const uint8_t*)bytes, (const int32_t*)qt, n, (int32_t*)out);
  } else {
    golomb_step_kernel<1><<<1, 32, smem, s>>>(
        (const int32_t*)vlc0, rows, (const int32_t*)pix,
        (const uint8_t*)bytes, (const int32_t*)qt, n, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
