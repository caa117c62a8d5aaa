// Adaptive range-decoder lane scan (FFV1 decode, planar, 3-input context, and
// with FIVE the 5-input context of context model 1), coded widths <= 10 bits.
//
// Replaces the Pallas TPU kernel tpu_ffv1/tpu/rc_dec_pallas.py `_kernel`
// (fast branch, launched by `_dec_plane_call` through
// `rc_decode_planes_pallas`): five=False (K2), and five=True (K2-five: the
// y-2 ring row rowbuf2, :201-206, and LL, TT in the context, :237-241).  Same
// computation: for each of L slice lanes, pixel-serial decode of every plane:
// the context from the quantized gradients of reconstructed neighbours,
// get_symbol through the distinct-slot schedule (zero flag, exponent unary +
// stop, mantissa MSB->LSB, sign), median prediction + residual folded to
// `bits`; states/low/range/pos chain across the planes.  Behaviour of
// ffv1dec.c:42-63 (get_symbol), :100-181 (decode_line) and
// rangecoder.h:104-145 (get_rac/refill).
//
// What bounds it on the H100: the serial decision chain (each decision needs
// the previous one's low/range and the pixel's context needs the previous
// pixel's value), about 5-17 dependent decisions per pixel at 8 bits; bytes
// are ~1.3 per pixel in and 4 out.  At one lane per SM only L of the 132 SMs
// work.  With the table in global memory (below) the row read lies on the
// chain too: a pixel's context needs the pixel just decoded, and its row
// comes from L1/L2.
//
// Design: one warp per lane, all planes in one launch.  The lane's state
// table (CC x 32 B, 42,624 B on the main path), the one/zero tables, the
// three (FIVE: five) quant tables and two reconstructed rows (previous and
// current, w + 1 int32 each) live in shared memory.  Context model 1's table
// (2 x 7,563 rows at 8 bits, 484,032 B) does not fit a block: the GTAB
// instance keeps it in global memory instead, adapted in place in states_out,
// which the wrapper fills with states0 (L2-resident: 23.2 MB for 48 lanes);
// the chain code is the same, only where `st` points differs, and the wrapper
// picks the instance from the table's size. FIVE adds TT, the stale cur[x] of
// the 2-row ring (row y-2, zeros for y < 2 since the rows are zeroed per
// plane), read before thread 0 overwrites it, and LL, the previous pixel's L
// (0 at x = 0).  Thread t reads and writes only byte t of a row, in either
// placement, so a pixel sees the bytes the pixels before it adapted.
//
// Thread t owns position t of the context row; every thread runs the decision
// chain redundantly (the values are identical, so every branch is
// warp-uniform and the exponent/mantissa loops stop where the symbol ends),
// reading slot states from their owners with shuffles, and each owner adapts
// its position after the pixel (positions touched in one pixel are pairwise
// distinct at bits <= 10).  Slice bytes are read from global memory through a
// 32-byte window held one byte per thread and refreshed before a pixel could
// run past it; reads at pos >= cap give 0.  The context index is clamped so
// damaged streams stay inside the table.
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define MAX_PLANES 4

struct PlaneSpecs {
  int n;
  int w[MAX_PLANES], h[MAX_PLANES], pbase[MAX_PLANES], off[MAX_PLANES];
};

template <int BITS, bool FIVE, bool GTAB>
__global__ void __launch_bounds__(32) rc_decode_kernel(
    const uint8_t* __restrict__ bufs, int cap,
    const uint8_t* __restrict__ states0, const uint8_t* __restrict__ one_tab,
    const uint8_t* __restrict__ zero_tab, const int32_t* __restrict__ qt,
    const int32_t* __restrict__ low0, const int32_t* __restrict__ range0,
    const int32_t* __restrict__ pos0, PlaneSpecs specs,
    int32_t* __restrict__ out, int out_stride,
    int32_t* __restrict__ low_out, int32_t* __restrict__ range_out,
    int32_t* __restrict__ pos_out, uint8_t* __restrict__ states_out,
    int CC, int wmax) {
  constexpr int E_MAX = BITS - 1;
  constexpr int MAXDEC = 2 * BITS + 1;     // decisions per pixel, at most
  constexpr int MASK_V = (1 << BITS) - 1;
  constexpr int NQ = FIVE ? 5 : 3;         // quant tables read
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  // CC x 32 state table: shared memory, or the lane's rows of states_out
  uint8_t* st = GTAB ? states_out + (size_t)lane * CC * 32 : smem;
  int32_t* qt_s = reinterpret_cast<int32_t*>(smem + (GTAB ? 0 : CC * 32));
  uint8_t* one_s = reinterpret_cast<uint8_t*>(qt_s + NQ * 256);
  uint8_t* zero_s = one_s + 256;
  int32_t* rowA = reinterpret_cast<int32_t*>(zero_s + 256);
  int32_t* rowB = rowA + (wmax + 1);

  if (!GTAB) {
    const uint4* src = reinterpret_cast<const uint4*>(
        states0 + (size_t)lane * CC * 32);
    for (int i = t; i < CC * 2; i += 32)
      reinterpret_cast<uint4*>(st)[i] = src[i];
  }
  for (int i = t; i < NQ * 256; i += 32) qt_s[i] = qt[i];
  for (int i = t; i < 256; i += 32) {
    one_s[i] = one_tab[i];
    zero_s[i] = zero_tab[i];
  }

  const uint8_t* buf = bufs + (size_t)lane * cap;
  int low = low0[lane], rng = range0[lane], pos = pos0[lane];
  int wbase = pos;
  int wbyte = (pos + t < cap) ? buf[pos + t] : 0;
  int32_t* out_l = out + (size_t)lane * out_stride;

  for (int pl = 0; pl < specs.n; ++pl) {
    const int w = specs.w[pl], h = specs.h[pl], pbase = specs.pbase[pl];
    int32_t* out_p = out_l + specs.off[pl];
    for (int i = t; i <= wmax; i += 32) { rowA[i] = 0; rowB[i] = 0; }
    __syncwarp();
    int32_t* cur = rowA;
    int32_t* prev = rowB;
    for (int y = 0; y < h; ++y) {
      // row borders (ffv1dec.c:202-203): L at x=0 is the previous row's
      // first sample, LT the first sample of the row before that (the
      // stale content of the 2-row ring)
      int Lv = prev[0];
      int LT = cur[0];
      int LL = 0;
      __syncwarp();
      for (int x = 0; x < w; ++x) {
        const int T = prev[x];
        const int RT = prev[min(x + 1, w - 1)];
        int ctx = qt_s[(Lv - LT) & 0xFF] + qt_s[256 + ((LT - T) & 0xFF)] +
                  qt_s[512 + ((T - RT) & 0xFF)];
        if (FIVE) {
          const int TT = cur[x];          // row y-2, before thread 0 writes
          ctx += qt_s[768 + ((LL - Lv) & 0xFF)] +
                 qt_s[1024 + ((TT - T) & 0xFF)];
        }
        const bool csign = ctx < 0;
        if (csign) ctx = -ctx;
        const int ci = min(max(ctx + pbase, 0), CC - 1);
        uint8_t* row = st + ci * 32;
        const int mys = row[t];
        if (pos + MAXDEC > wbase + 32) {
          wbase = pos;
          wbyte = (pos + t < cap) ? buf[pos + t] : 0;
        }
        bool touched = false;
        int tbit = 0;
        // one get_rac decision at row position p
        auto rac = [&](int p) -> int {
          const int s = __shfl_sync(FULL_MASK, mys, p);
          const int nxt = __shfl_sync(FULL_MASK, wbyte, (pos - wbase) & 31);
          const int r1 = (rng * s) >> 8;
          const int r0 = rng - r1;
          const int bit = low >= r0;
          if (bit) {
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
          if (t == p) {
            touched = true;
            tbit = bit;
          }
          return bit;
        };
        int diff = 0;
        if (!rac(0)) {                     // nonzero symbol
          int e = 0;
          while (e <= E_MAX && rac(1 + e)) ++e;   // unary exponent + stop
          int a = 1;
          // e reaches E_MAX + 1 only on damaged streams; the mantissa
          // then still has E_MAX decisions (dec_scan_lanes.py:171)
          for (int j = 0; j < min(e, E_MAX); ++j)
            a = 2 * a + rac(22 + min(max(e - 1 - j, 0), 9));
          const int sbit = rac(11 + min(e, 10));
          diff = sbit ? -a : a;
        }
        if (touched) row[t] = tbit ? one_s[mys] : zero_s[mys];
        if (csign) diff = -diff;
        const int m2 = Lv + T - LT;
        const int pred = Lv + m2 + T - min(min(Lv, m2), T) -
                         max(max(Lv, m2), T);
        const int val = (pred + diff) & MASK_V;
        if (t == 0) cur[x] = val;
        LT = T;
        LL = Lv;
        Lv = val;
      }
      __syncwarp();
      for (int x = t; x < w; x += 32) out_p[y * w + x] = cur[x];
      int32_t* tmp = cur;
      cur = prev;
      prev = tmp;
      __syncwarp();
    }
  }
  if (t == 0) {
    low_out[lane] = low;
    range_out[lane] = rng;
    pos_out[lane] = pos;
  }
  if (!GTAB) {
    uint4* dst = reinterpret_cast<uint4*>(states_out + (size_t)lane * CC * 32);
    for (int i = t; i < CC * 2; i += 32)
      dst[i] = reinterpret_cast<const uint4*>(st)[i];
  }
}

template <int BITS, bool FIVE, bool GTAB>
static int launch(const void* bufs, int cap, const void* states0,
                  const void* one_tab, const void* zero_tab, const void* qt,
                  const void* low0, const void* range0, const void* pos0,
                  const PlaneSpecs& specs, void* out, int out_stride,
                  void* low_out, void* range_out, void* pos_out,
                  void* states_out, int L, int CC, int wmax,
                  cudaStream_t stream) {
  const size_t smem = (GTAB ? 0 : (size_t)CC * 32) +
                      (FIVE ? 5 : 3) * 256 * 4 + 512 +
                      2 * (size_t)(wmax + 1) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rc_decode_kernel<BITS, FIVE, GTAB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rc_decode_kernel<BITS, FIVE, GTAB><<<L, 32, smem, stream>>>(
      (const uint8_t*)bufs, cap, (const uint8_t*)states0,
      (const uint8_t*)one_tab, (const uint8_t*)zero_tab, (const int32_t*)qt,
      (const int32_t*)low0, (const int32_t*)range0, (const int32_t*)pos0,
      specs, (int32_t*)out, out_stride, (int32_t*)low_out,
      (int32_t*)range_out, (int32_t*)pos_out, (uint8_t*)states_out, CC,
      wmax);
  return (int)cudaGetLastError();
}

// Plain C entry point: returns the cudaError_t of the launch (0 = ok).
// spec is a host array of nplanes x (w, h, pbase) triples; plane k's
// samples start at column sum_{j<k} w_j * h_j of the (L, out_stride) out.
// five != 0 selects the 5-input context (qt holds five tables); gtab != 0
// the table-in-global-memory instance, where states_out must hold a copy
// of states0.
extern "C" int rc_decode_launch(
    const void* bufs, int cap, const void* states0, const void* one_tab,
    const void* zero_tab, const void* qt, const void* low0,
    const void* range0, const void* pos0, const int* spec, int nplanes,
    void* out, int out_stride, void* low_out, void* range_out,
    void* pos_out, void* states_out, int L, int CC, int bits, int five,
    int gtab, void* stream) {
  if (nplanes < 1 || nplanes > MAX_PLANES) return (int)cudaErrorInvalidValue;
  PlaneSpecs specs;
  specs.n = nplanes;
  int off = 0, wmax = 1;
  for (int k = 0; k < nplanes; ++k) {
    specs.w[k] = spec[3 * k];
    specs.h[k] = spec[3 * k + 1];
    specs.pbase[k] = spec[3 * k + 2];
    specs.off[k] = off;
    off += specs.w[k] * specs.h[k];
    wmax = specs.w[k] > wmax ? specs.w[k] : wmax;
  }
  if (off > out_stride) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define RC_DEC_ARGS                                                       \
  bufs, cap, states0, one_tab, zero_tab, qt, low0, range0, pos0, specs,  \
      out, out_stride, low_out, range_out, pos_out, states_out, L, CC,   \
      wmax, s
#define RC_DEC_CASE(B)                                                    \
  case B:                                                                 \
    return five ? (gtab ? launch<B, true, true>(RC_DEC_ARGS)              \
                        : launch<B, true, false>(RC_DEC_ARGS))            \
                : (gtab ? launch<B, false, true>(RC_DEC_ARGS)             \
                        : launch<B, false, false>(RC_DEC_ARGS));
  switch (bits) {
    RC_DEC_CASE(1) RC_DEC_CASE(2) RC_DEC_CASE(3) RC_DEC_CASE(4)
    RC_DEC_CASE(5) RC_DEC_CASE(6) RC_DEC_CASE(7) RC_DEC_CASE(8)
    RC_DEC_CASE(9) RC_DEC_CASE(10)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RC_DEC_CASE
#undef RC_DEC_ARGS
}
