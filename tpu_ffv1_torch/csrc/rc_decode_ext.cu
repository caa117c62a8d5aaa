// Adaptive range-decoder lane scan (FFV1 decode, planar, 3-input context, and
// with FIVE the 5-input context of context model 1), extended schedule for
// coded widths 11..17 bits (K2-ext, K2-ext-five).
//
// Replaces the Pallas TPU kernel tpu_ffv1/tpu/rc_dec_pallas.py `_kernel` at
// bits > 10, five=False and five=True (:201-206, 237-241, the y-2 ring row
// and LL/TT in the context): its running rows 10/31
// (rc_dec_pallas.py:343-363, 364-381), the capped row addressing (:398-401),
// the int16 ring-row wrap at 16 bits (:435-439) and the wider byte feed
// (:214-215), launched through `rc_decode_planes_pallas`.  Same computation
// as dec_scan_lanes.rc_decode_planes_lanes: for each of L slice lanes,
// pixel-serial decode of every plane; get_symbol with put_symbol's row caps
// (exponent row 1 + min(j, 9), mantissa row 22 + min(i, 9), sign row 11 +
// min(e, 10), ffv1dec.c:42-63); median prediction + residual folded to
// `bits`; at 16 bits the sample is stored int16-wrapped, so the predictor and
// the context compare it signed.  Behaviour of ffv1dec.c:100-181
// (decode_line) and rangecoder.h:104-145 (get_rac/refill).
//
// What bounds it on the H100: as K2, the serial decision chain, here up to 2
// * BITS + 1 dependent decisions per pixel (33 at 16 bits), each decision on
// rows 10/31 also waiting on a shared-memory table load; bytes are ~3 per
// pixel in and 4 out.  One lane per SM: L of the 132 SMs work.  With the
// table in global memory the row read lies on the chain too.
//
// Design: K2's, one warp per lane, all planes in one launch; state table,
// one/zero tables, quant tables and two reconstructed rows in shared memory
// (49 KB at w = 320 with two state planes, so the launch raises the dynamic
// shared-memory limit).  At context model 1 the table (2 x 5,063 rows from
// the 16-bit extradata, 324,032 B) does not fit a block: the GTAB instance
// adapts it in place in global memory, in states_out, which the wrapper fills
// with states0; the chain code is the same.  FIVE adds TT (the stale cur[x]
// of the 2-row ring: row y-2) and LL (the previous pixel's L, 0 at x = 0) as
// in K2-five; both are int16-wrapped at 16 bits like every stored sample.
//
// Every thread runs the chain redundantly; single-touch positions are read
// from their owners by shuffle and adapted by the owner after the pixel.
// Rows 10 and 31 are running values s10/s31 in every thread, advanced after
// each decision on them; their owners store them after the pixel.  A pixel
// can take 35 decisions, more than K2's 32-byte window holds, so the byte
// window is 64 bytes, two per thread (byte o of the window in thread o & 31,
// register o >> 5), refreshed before a pixel could run past it.  Reads at pos
// >= cap give 0 and the context index is clamped, so damaged streams stay in
// bounds.
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define MAX_PLANES 4
#define WIN 64

struct PlaneSpecs {
  int n;
  int w[MAX_PLANES], h[MAX_PLANES], pbase[MAX_PLANES], off[MAX_PLANES];
};

template <int BITS, bool FIVE, bool GTAB>
__global__ void __launch_bounds__(32) rc_decode_ext_kernel(
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
  static_assert(MAXDEC <= WIN, "a pixel must fit the byte window");
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
  int wb0 = (pos + t < cap) ? buf[pos + t] : 0;
  int wb1 = (pos + 32 + t < cap) ? buf[pos + 32 + t] : 0;
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
        if (pos + MAXDEC > wbase + WIN) {
          wbase = pos;
          wb0 = (pos + t < cap) ? buf[pos + t] : 0;
          wb1 = (pos + 32 + t < cap) ? buf[pos + 32 + t] : 0;
        }
        int s10 = __shfl_sync(FULL_MASK, mys, 10);
        int s31 = __shfl_sync(FULL_MASK, mys, 31);
        bool touched = false;
        int tbit = 0;
        // one get_rac decision on state s; returns the bit and leaves the
        // range coder advanced (the caller adapts the state)
        auto decide = [&](int s) -> int {
          const int o = pos - wbase;      // warp-uniform, < WIN
          const int nxt = __shfl_sync(FULL_MASK, o < 32 ? wb0 : wb1, o & 31);
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
          return bit;
        };
        // a decision at single-touch position p (its owner adapts it)
        auto rac = [&](int p) -> int {
          const int bit = decide(__shfl_sync(FULL_MASK, mys, p));
          if (t == p) {
            touched = true;
            tbit = bit;
          }
          return bit;
        };
        // a decision on a running row (10 or 31)
        auto rac_run = [&](int& s) -> int {
          const int bit = decide(s);
          s = bit ? one_s[s] : zero_s[s];
          return bit;
        };
        int diff = 0;
        if (!rac(0)) {                     // nonzero symbol
          int e = 0;
          // unary exponent + stop: rows 1..9, then row 10 repeated
          while (e <= E_MAX && (e < 9 ? rac(1 + e) : rac_run(s10))) ++e;
          int a = 1;
          // e reaches E_MAX + 1 only on damaged streams; the mantissa
          // then still has E_MAX decisions (dec_scan_lanes.py:171)
          for (int j = 0; j < min(e, E_MAX); ++j) {
            const int i = e - 1 - j;        // >= 0 since j < e
            a = 2 * a + (i >= 9 ? rac_run(s31) : rac(22 + i));
          }
          const int sbit = rac(11 + min(e, 10));
          diff = sbit ? -a : a;
        }
        if (t == 10) {
          row[t] = (uint8_t)s10;
        } else if (t == 31) {
          row[t] = (uint8_t)s31;
        } else if (touched) {
          row[t] = tbit ? one_s[mys] : zero_s[mys];
        }
        if (csign) diff = -diff;
        const int m2 = Lv + T - LT;
        const int pred = Lv + m2 + T - min(min(Lv, m2), T) -
                         max(max(Lv, m2), T);
        int val = (pred + diff) & MASK_V;
        if (BITS == 16) val = ((val + 0x8000) & 0xFFFF) - 0x8000;
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
  __syncwarp();
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
        rc_decode_ext_kernel<BITS, FIVE, GTAB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rc_decode_ext_kernel<BITS, FIVE, GTAB><<<L, 32, smem, stream>>>(
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
extern "C" int rc_decode_ext_launch(
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
#define RC_DEC_EXT_CASE(B)                                                \
  case B:                                                                 \
    return five ? (gtab ? launch<B, true, true>(RC_DEC_ARGS)              \
                        : launch<B, true, false>(RC_DEC_ARGS))            \
                : (gtab ? launch<B, false, true>(RC_DEC_ARGS)             \
                        : launch<B, false, false>(RC_DEC_ARGS));
  switch (bits) {
    RC_DEC_EXT_CASE(11) RC_DEC_EXT_CASE(12) RC_DEC_EXT_CASE(13)
    RC_DEC_EXT_CASE(14) RC_DEC_EXT_CASE(15) RC_DEC_EXT_CASE(16)
    RC_DEC_EXT_CASE(17)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RC_DEC_EXT_CASE
#undef RC_DEC_ARGS
}
