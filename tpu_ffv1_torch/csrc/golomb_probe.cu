// Latency of one dependent step of the Golomb-Rice lane scans on one warp
// (G1, golomb_encode.cu; G2, golomb_decode.cu), which run one warp per slice
// lane: a VLC-coded pixel's, and a run's (G1: a completed run chunk of the
// run machine; G2: a pixel inside a run).  The yardstick of their chain
// bound: no lane goes faster than its VLC-coded pixels and run steps, each
// at this latency.
//
// Not a port of a TPU kernel and not on the codec's path: chip_smoke.py
// launches it once per mode on a single warp, times it with CUDA events and
// holds its result against the plain loop (tpu_ffv1_torch/kernels/probes.py
// golomb_step_ref).  Each iteration is one pixel outside a run, in the
// kernels' own instructions and order, on thread 0 as the kernels run their
// chains:
//   mode 0 (encode, as G1's VLC loop): the pixel's context and residual
//     known in advance (a 32-entry array in shared memory), so the next
//     pixel's row read issues before this pixel's row is stored, and is
//     taken from this pixel's update where the contexts are equal; the
//     residual folded under the row's bias, the symbol and the row it was
//     coded under stored for the packing (a 128-entry ring), the row
//     updated (golomb_vlc.cuh) and stored;
//   mode 1 (decode, as G2's): the context from the row-parallel part plus
//     the quantized L - LT of the pixel before, the row and its cached k
//     (or the last pixel's, where the context repeats), the code read from a
//     64-bit window in registers fed with the words of a ring of 512 random
//     bytes (the unary prefix by a leading-zero count, the escape, the
//     mantissa by a funnel shift), the median prediction from L, T and LT,
//     and the sample; the next pixel's context waits on it, and its code on
//     the position this code ended at;
//   mode 2 (a run chunk, as G1's run machine): the chunk's size from the run
//     index, the popcount of the zero-residual mask, the position of the
//     chunk's last pixel (nth_bit) and the mask past it; a fresh chunk of 32
//     pixels where the mask runs out;
//   mode 3 (a run pixel, as G2's): the median of L, T and L + T - LT with a
//     zero residual, stored.
// The pixel loop is not unrolled, so chip_smoke.py can count its SASS
// instructions (cuobjdump -sass) for the operations term of G1's and G2's
// roofline bound.  Shared memory: the table (rows x 16 B), the 32 pixels'
// inputs, one quant table, the ring and (mode 1) each row's k.
#include <cuda_runtime.h>
#include <stdint.h>

#include "golomb_vlc.cuh"  // log2_run, vlc_k, update_vlc

enum : int { RING = 512, BITS = 8 };

// the position of the k-th (from 0) set bit of m, k < popc(m), as G1's
__device__ __forceinline__ int nth_bit(unsigned m, int k) {
  int p = 0, c;
  c = __popc(m & 0xFFFFu);
  if (k >= c) { k -= c; m >>= 16; p += 16; }
  c = __popc(m & 0xFFu);
  if (k >= c) { k -= c; m >>= 8; p += 8; }
  c = __popc(m & 0xFu);
  if (k >= c) { k -= c; m >>= 4; p += 4; }
  c = __popc(m & 0x3u);
  if (k >= c) { k -= c; m >>= 2; p += 2; }
  return p + (k >= (int)(m & 1u) ? 1 : 0);
}

template <int MODE>
__global__ void __launch_bounds__(32) golomb_step_kernel(
    const int32_t* __restrict__ vlc0, int rows,
    const int32_t* __restrict__ pix, const uint8_t* __restrict__ bytes,
    const int32_t* __restrict__ qt, int n, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  int4* st = reinterpret_cast<int4*>(smem);
  int2* px = reinterpret_cast<int2*>(st + rows);
  int32_t* qt_s = reinterpret_cast<int32_t*>(px + 32);
  int32_t* ring = qt_s + 256;              // 512 int32: mode 0 the symbols'
  uint8_t* k_s = reinterpret_cast<uint8_t*>(ring + RING);   // ring, mode 1
  const int t = threadIdx.x;                                 // the words
  // the set-up loops stay rolled, so each mode's step loop is the largest
  // (chip_smoke.pixel_loop_count)
#pragma unroll 1
  for (int i = t; i < rows; i += 32) {
    const int4 r = reinterpret_cast<const int4*>(vlc0)[i];
    st[i] = r;
    k_s[i] = (uint8_t)vlc_k(r.w, r.y);
  }
  px[t] = make_int2(pix[2 * t], pix[2 * t + 1]);
#pragma unroll 1
  for (int i = t; i < 256; i += 32) qt_s[i] = qt[i];
#pragma unroll 1
  for (int i = t; i < RING; i += 32) {
    ring[i] = 0;
    if (MODE == 1 && i < RING / 4)         // word i of the bytes, MSB first
      ring[i] = (int32_t)((uint32_t)bytes[4 * i] << 24 |
                          (uint32_t)bytes[4 * i + 1] << 16 |
                          (uint32_t)bytes[4 * i + 2] << 8 | bytes[4 * i + 3]);
  }
  const int mask_v = (1 << BITS) - 1, half = 1 << (BITS - 1);
  __syncwarp();
  int s0 = 0, s1 = 0, s2 = 0;    // the chain's state, written out
  if (t == 0 && MODE == 0) {
    int2 e = px[0];
    int4 row = st[e.x];
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int2 en = px[(i + 1) & 31];
      const int4 loaded = st[en.x];        // before this pixel's store
      const int vf = ((e.y - row.z + half) & mask_v) - half;
      reinterpret_cast<int4*>(ring)[i & (RING / 4 - 1)] =
          make_int4(vf, row.x, row.w, row.y);
      const int4 nrow = update_vlc(row, vf);
      st[e.x] = nrow;
      row = en.x == e.x ? nrow : loaded;
      e = en;
      s1 = vf;
    }
    s0 = n;
  } else if (t == 0 && MODE == 2) {
    unsigned zeros = 0xffffffffu;
    int ri = 0, sum = 0;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int need = 1 << log2_run(ri & 15);
      if (__popc(zeros) < need) zeros = 0xffffffffu;
      const int p = nth_bit(zeros, need - 1);
      zeros &= p < 31 ? 0xffffffffu << (p + 1) : 0u;
      sum += p;
      ++ri;
    }
    s0 = ri;
    s1 = (int)zeros;
    s2 = sum;
  } else if (t == 0 && MODE == 3) {
    int Lv = 0, LT = 0;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int T = px[i & 31].x;
      const int val = min(max(Lv + T - LT, min(Lv, T)), max(Lv, T));
      ring[i & (RING - 1)] = val;
      LT = T;
      Lv = val;
    }
    s0 = n;
    s1 = Lv;
    s2 = LT;
  } else if (t == 0) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(ring);
    unsigned long long win = (unsigned long long)words[0] << 32;
    int nb = 32, wi = 1;
    uint32_t wn = words[1];
    int Lv = 0, LT = 0, last_c = -1, last_k = 0;
    int4 last_row = make_int4(0, 0, 0, 0);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int2 tc = px[i & 31];              // (T, context part)
      const int T = tc.x;
      const int ctx = tc.y + qt_s[(Lv - LT) & 0xFF];
      const int c = min(abs(ctx), rows - 1);
      const int pred = min(max(Lv + T - LT, min(Lv, T)), max(Lv, T));
      const bool take = nb < 32;
      win |= take ? (unsigned long long)wn << ((32 - nb) & 63) : 0ull;
      nb += take ? 32 : 0;
      wi += take ? 1 : 0;
      wn = words[wi & (RING / 4 - 1)];
      const uint32_t w32 = (uint32_t)(win >> 32);
      const int e = __clz((int)w32);
      const uint32_t rest = w32 << (e + 1);
      int4 row;
      int k;
      if (c == last_c) {
        row = last_row;
        k = last_k;
      } else {
        row = st[c];
        k = k_s[c];
      }
      int v, used;
      if (e >= 12) {
        v = (int)((w32 >> (20 - BITS)) & mask_v) + 11;
        used = 12 + BITS;
      } else {
        v = (int)__funnelshift_l(rest, (unsigned)e, (unsigned)k);
        used = e + 1 + k;
      }
      win <<= used;
      nb -= used;
      const int sv = (v >> 1) ^ -(v & 1) ^ ((2 * row.x + row.w) >> 31);
      const int x_res = sv + row.z;
      last_row = update_vlc(row, sv);
      last_k = vlc_k(last_row.w, last_row.y);
      last_c = c;
      st[c] = last_row;
      k_s[c] = (uint8_t)last_k;
      LT = T;
      Lv = (pred + (ctx < 0 ? -x_res : x_res)) & mask_v;
    }
    s0 = 32 * wi - nb;
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
  for (int i = t; i < RING; i += 32)
    out[4 + 4 * rows + i] = MODE == 1 ? bytes[i] : ring[i];
}

// Plain C entry point: returns the cudaError_t of the launch (0 = ok).  vlc0
// is int32 (rows, 4), pix int32 (32, 2) (mode 0: context < rows, residual;
// modes 1, 3: T, context part), bytes uint8 (512,) (mode 1), qt int32
// (256,); out int32 (4 + 4 * rows + 512,): the chain's state (mode 0:
// pixels, the last symbol; mode 1: bit position, L, LT; mode 2: run chunks,
// the mask, the sum of their last pixels' positions; mode 3: pixels, L, LT),
// the table, and the ring (mode 0: the last 128 pixels' symbol and row, int4
// each; mode 1: the bytes; mode 2: zeros; mode 3: the last 512 samples).
extern "C" int golomb_step_launch(const void* vlc0, int rows, const void* pix,
                                  const void* bytes, const void* qt, int n,
                                  int mode, void* out, void* stream) {
  const size_t smem = (size_t)rows * 17 + 32 * 8 + 256 * 4 + RING * 4;
  if (rows < 1 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define GOLOMB_STEP_CASE(M)                                               \
  case M:                                                                 \
    golomb_step_kernel<M><<<1, 32, smem, s>>>(                            \
        (const int32_t*)vlc0, rows, (const int32_t*)pix,                  \
        (const uint8_t*)bytes, (const int32_t*)qt, n, (int32_t*)out);     \
    break;
  switch (mode) {
    GOLOMB_STEP_CASE(0)
    GOLOMB_STEP_CASE(1)
    GOLOMB_STEP_CASE(2)
    GOLOMB_STEP_CASE(3)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GOLOMB_STEP_CASE
  return (int)cudaGetLastError();
}
