// Golomb-Rice decode lane scan (FFV1 coder=0, the reference's default coder),
// planar, 3-input context and with FIVE the 5-input context of context model
// 1: G2.
//
// Replaces the XLA scan of the JAX package, tpu_ffv1/tpu/golomb_dec_lanes.py
// `golomb_decode_planes_lanes` (no Pallas kernel: a two-level lax.scan per
// plane, vectorised over lanes).  Same computation: for each of L slice
// lanes, pixel-serial decode of every plane: the context from the quantized
// gradients of reconstructed neighbours, the run-mode state machine (the
// refill bit, a long run of 2^log2_run[run_index] or a short one of log2_run
// bits, the ended pixel's +1), get_vlc_symbol under the context's adaptive
// VlcState (get_ur_golomb with limit 12 and esc_len = bits, the sign flip by
// the drift, update_vlc_state), median prediction + residual folded to
// `bits`; VLC states and the bit position chain across the planes.
// Behaviour of ffv1dec.c:70-98, :139-170 and golomb.h:268-300, and of the
// JAX scan: bits are read MSB first from the lane's bytes, zero past cap; the
// int16 sample wrap at 16 bits.
//
// What bounds it on the H100: the serial chain, one lane per warp and one
// warp per SM (L = 48 of the 132 SMs on the 1080p main path).  Bytes are few
// (about half a byte in and 4 out per pixel); each VLC-coded pixel's
// context, so its VlcState row, needs the value the pixel before decoded,
// and its code the bit position that pixel's code ended at.  One thread
// issues the chain, so its time follows the pixel loop's instruction count
// (about two cycles each, measured) as much as those latencies.
//
// The design:
//
// - Thread 0 alone runs the chain (no redundant copies, so no thread can
//   read a row another has rewritten, and the chain has no __syncwarp); the
//   warp does the work between rows.
// - The bit window is in registers: 64 bits, MSB first, and the next
//   32-bit word of the stream already loaded beside it.  Before each read
//   (the run bits, then a code: at most 25 and 29 bits) a window below 32
//   bits takes that word in (a shift and an OR) and loads the word after
//   it, so no load waits on the chain; a code is a leading-zero count and
//   shifts of registers.
// - The words come from a ring in shared memory, stored MSB first.  At
//   each row's start the warp tops the ring up, from global memory, to
//   every word the row can read: a pixel reads at most 54 bits (a run's 1
//   + 24 and a code of 29), so a row of w pixels at most 54 w.
// - Runs: once a run's length is read, its pixels need only the median
//   recurrence with a zero residual: no context, no table, no window.
//   The context is computed only where a code is read or a run may start.
// - The row read: where a VLC-coded pixel's context is the last one's, the
//   row comes from registers (that pixel's update), not from the table.
//   Each row's Golomb parameter k is kept in a byte beside the table and
//   rewritten with the row, so k reaches the chain with the row and not a
//   dependent step after it; the prefix and the k mantissa bits are one
//   funnel shift.  The residual is folded by the sample's mask, except at
//   a run's end, whose +1 needs it folded first.
// - A row-parallel context: at each row's start the warp computes, 32
//   columns at a time, the part of every pixel's context that does not
//   depend on the row being decoded (LT - T, T - RT; FIVE: TT - T, TT the
//   stale entry of the 2-row ring, row y-2); the chain adds L's terms
//   (L - LT; FIVE: LL - L).
// - The Golomb parameter k, ff_log2_run and the VlcState update are G1's
//   (csrc/golomb_vlc.cuh).
//
// Table placement: the lane's VLC table (CC rows of 16 B: 21,312 B at context
// model 0), the quant tables (three, FIVE: five), the word ring (RW words:
// launch sizes it for the widest plane), two reconstructed rows, the row's
// (T, context part) pairs and each table row's k live in shared memory.  Context model 1's
// table (2 x 7,563 rows, 242,016 B) does not fit a block: the GTAB instance
// keeps it in global memory, adapted in place in vlc_out, which the wrapper
// fills with vlc0; the chain code is the same.  The context index is clamped
// so damaged streams stay inside the table.
//
// Stage probes (STAGES != ALL_STAGES, reached through
// golomb_decode_stages_launch and never by the codec): the same kernel with
// one stage stubbed, for timing only (their outputs are wrong on purpose,
// and a stubbed stage changes the decoded symbols, so the split is an
// indication).  WINDOW: the bit window and its ring (stubbed: bits made
// from the position); CTX: the chain's quant-table lookups of L's terms
// (stubbed: the row-parallel part alone); VLC: the row read and update
// (stubbed: a fixed row); RECON: the median prediction (stubbed: T).  The
// production instances are ALL_STAGES.
#include <cuda_runtime.h>
#include <stdint.h>

#include "golomb_vlc.cuh"  // log2_run, vlc_k, update_vlc

#define MAX_PLANES 4

enum : int {
  STAGE_WINDOW = 1,
  STAGE_CTX = 2,
  STAGE_VLC = 4,
  STAGE_RECON = 8,
  ALL_STAGES = 15
};

struct PlaneSpecs {
  int n;
  int w[MAX_PLANES], h[MAX_PLANES], pbase[MAX_PLANES], off[MAX_PLANES];
};

// the ring words a row of w pixels can take in: 54 bits a pixel, and the
// word under way
__host__ __device__ __forceinline__ int row_words(int w) {
  return (54 * w + 31) / 32 + 2;
}

template <bool FIVE, bool GTAB, int STAGES>
__global__ void __launch_bounds__(32) golomb_decode_kernel(
    const uint8_t* __restrict__ bufs, int cap,
    const int32_t* __restrict__ vlc0, const int32_t* __restrict__ qt,
    const int32_t* __restrict__ pos0, PlaneSpecs specs,
    int32_t* __restrict__ out, int out_stride,
    int32_t* __restrict__ bitpos_out, int32_t* __restrict__ vlc_out, int CC,
    int bits, int wmax, int RW) {
  constexpr int NQ = FIVE ? 5 : 3;               // quant tables read
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  // CC x 4 VLC table: shared memory, or the lane's rows of vlc_out
  int4* st = GTAB ? reinterpret_cast<int4*>(vlc_out) + (size_t)lane * CC
                  : reinterpret_cast<int4*>(smem);
  int32_t* qt_s = reinterpret_cast<int32_t*>(smem + (GTAB ? 0 : CC * 16));
  uint32_t* ring = reinterpret_cast<uint32_t*>(qt_s + NQ * 256);  // RW words
  int2* tc_s = reinterpret_cast<int2*>(ring + RW);    // (T, ctx part)
  int32_t* rowA = reinterpret_cast<int32_t*>(tc_s + (wmax + 1));
  int32_t* rowB = rowA + (wmax + 1);
  int* wi_s = rowB + (wmax + 1);                     // the chain's next word
  uint8_t* k_s = reinterpret_cast<uint8_t*>(wi_s + 4);  // each row's k

  if (!GTAB) {
    const int4* src = reinterpret_cast<const int4*>(vlc0) + (size_t)lane * CC;
    for (int i = t; i < CC; i += 32) st[i] = src[i];
  }
  // quant tables 0, 1, 2 (FIVE: and 3, 4)
  for (int i = t; i < NQ * 256; i += 32) qt_s[i] = qt[i];
  // each row's Golomb parameter, kept beside the table: k reaches the
  // chain with the row, not a dependent step after it
  {
    const int4* rows0 = reinterpret_cast<const int4*>(vlc0) + (size_t)lane * CC;
    for (int i = t; i < CC; i += 32) {
      const int4 r = rows0[i];
      k_s[i] = (uint8_t)vlc_k(r.w, r.y);
    }
  }

  const uint8_t* buf = bufs + (size_t)lane * cap;
  // the ring holds the stream's words [.., hi), word i MSB first (bytes
  // 4i..4i+3, 0 past cap), in slot i & (RW - 1)
  auto fill = [&](int from, int to) {
    for (int i = from + t; i < to; i += 32) {
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * i + k;
        v = (v << 8) | (j < cap ? buf[j] : 0u);
      }
      ring[i & (RW - 1)] = v;
    }
  };
  const int bp0 = pos0[lane] * 8;
  int hi = bp0 >> 5;
  if constexpr ((STAGES & STAGE_WINDOW) != 0) {
    fill(hi, hi + 4);
    hi += 4;
  }
  const int mask_v = (1 << bits) - 1, half = 1 << (bits - 1);
  int32_t* out_l = out + (size_t)lane * out_stride;
  // the chain's state (thread 0's): the window's bits [bp, bp + nb) of the
  // stream, MSB first in win; word wi, the next to take in, in wn; so
  // bp = 32 wi - nb
  unsigned long long win = 0;
  int nb = 0, wi = 0;
  uint32_t wn = 0;
  int last_c = -1;                       // the row last adapted, its value
  int4 last_row = make_int4(0, 0, 0, 0);  // and its k
  int last_k = 0;
  __syncwarp();
  if (t == 0) {
    wi = (bp0 >> 5) + 1;
    nb = 32 - (bp0 & 31);
    if constexpr ((STAGES & STAGE_WINDOW) != 0) {
      win = (unsigned long long)ring[(wi - 1) & (RW - 1)] << (64 - nb);
      wn = ring[wi & (RW - 1)];
    }
    wi_s[0] = wi;
  }
  // the window's next 32 bits, with at least 32 valid: below 32, the word
  // in wn comes in (selects, no branch) and the word after it is loaded
  auto peek = [&]() -> uint32_t {
    if constexpr ((STAGES & STAGE_WINDOW) == 0)  // stub: bits from bp
      return (uint32_t)(32 * wi - nb) * 2654435761u;
    const bool take = nb < 32;
    win |= take ? (unsigned long long)wn << ((32 - nb) & 63) : 0ull;
    nb += take ? 32 : 0;
    wi += take ? 1 : 0;
    wn = ring[wi & (RW - 1)];
    return (uint32_t)(win >> 32);
  };
  auto consume = [&](int n) {
    win <<= n;
    nb -= n;
  };
  // sample rows wrap to int16_t at 16 bits: (x + wrap) & mask - wrap
  const int wrap = bits == 16 ? 0x8000 : 0;

  for (int pl = 0; pl < specs.n; ++pl) {
    const int w = specs.w[pl], h = specs.h[pl], pbase = specs.pbase[pl];
    int32_t* out_p = out_l + specs.off[pl];
    for (int i = t; i <= wmax; i += 32) {
      rowA[i] = 0;
      rowB[i] = 0;
    }
    __syncwarp();
    int32_t* cur = rowA;
    int32_t* prev = rowB;
    int run_index = 0;                   // per plane
    for (int y = 0; y < h; ++y) {
      // the part of each pixel's context that does not depend on the row
      // being decoded, 32 columns at a time: LT - T and T - RT (FIVE: TT -
      // T, TT the stale cur[x] of the 2-row ring, row y-2); LT at x = 0 is
      // the stale cur[0]
      for (int x = t; x < w; x += 32) {
        const int T = prev[x];
        const int LT = x > 0 ? prev[x - 1] : cur[0];
        const int RT = prev[min(x + 1, w - 1)];
        int cp = qt_s[256 + ((LT - T) & 0xFF)] +
                 qt_s[512 + ((T - RT) & 0xFF)];
        if (FIVE) cp += qt_s[1024 + ((cur[x] - T) & 0xFF)];
        tc_s[x] = make_int2(T, cp);
      }
      if (t == w % 32) tc_s[w] = make_int2(0, 0);   // read ahead, unused
      // the ring to every word this row can take in
      if constexpr ((STAGES & STAGE_WINDOW) != 0) {
        const int to = wi_s[0] + row_words(w);
        if (to > hi) {
          fill(hi, to);
          hi = to;
        }
      }
      __syncwarp();
      if (t == 0) {
        // row borders: L at x = 0 is the previous row's first sample, LT
        // the first sample of the row before that
        int Lv = prev[0], LT = cur[0], LL = 0;
        int run_mode = 0, run_count = 0;
        int2 tc_next = tc_s[0];
        int x = 0;
        while (x < w) {
          const int2 tc = tc_next;
          tc_next = tc_s[x + 1];
          const int T = tc.x;
          int ctx = tc.y;
          if constexpr ((STAGES & STAGE_CTX) != 0) {
            ctx += qt_s[(Lv - LT) & 0xFF];
            if (FIVE) ctx += qt_s[768 + ((LL - Lv) & 0xFF)];
          }
          const int actx = abs(ctx);
          const int pred = (STAGES & STAGE_RECON) == 0
                               ? T
                               : min(max(Lv + T - LT, min(Lv, T)),
                                     max(Lv, T));
          bool ended = false;
          if (run_mode != 0 || actx == 0) {
            // run mode (ffv1dec.c:139-170); run_count is 0 here: a run's
            // pixels go by below at once
            if (run_mode == 0) run_mode = 1;
            if (run_mode == 1) {
              const int lr = log2_run(run_index);
              const uint32_t w32 = peek();
              if (w32 >> 31) {           // a full run chunk
                run_count = 1 << lr;
                if (x + run_count <= w) ++run_index;
                consume(1);
              } else {                   // a short run: lr bits of length
                run_count = lr ? (int)((w32 << 1) >> (32 - lr)) : 0;
                consume(1 + lr);
                if (run_index > 0) --run_index;
                run_mode = 2;
              }
            }
            if (run_count > 0) {         // zero residuals: the median alone
              const int n = min(run_count, w - x);
              run_count -= n;
              int Tx = T, val = pred;
              for (int i = 0;;) {
                cur[x + i] = val;
                LT = Tx;
                LL = Lv;
                Lv = val;
                if (++i == n) break;
                Tx = tc_s[x + i].x;
                val = (STAGES & STAGE_RECON) == 0
                          ? Tx
                          : min(max(Lv + Tx - LT, min(Lv, Tx)), max(Lv, Tx));
              }
              x += n;
              tc_next = tc_s[x];
              continue;
            }
            ended = true;                // the run ends at this pixel
            run_mode = 0;
          }
          // get_vlc_symbol: the unary prefix from the window before the row
          const uint32_t w32 = peek();
          const int e = __clz((int)w32);
          const uint32_t rest = w32 << (e + 1);  // the mantissa, MSB first
          const int c = min(actx + pbase, CC - 1);
          int4 row;
          int k;
          if constexpr ((STAGES & STAGE_VLC) != 0) {
            if (c == last_c) {           // the row this context last took
              row = last_row;
              k = last_k;
            } else {
              row = st[c];
              k = k_s[c];
            }
          } else {
            row = make_int4(0, 8, 0, 4);  // stub: a fixed row
            k = 1;
          }
          int v;
          if (e >= 12) {                 // escape: limit 12, esc_len = bits
            v = (int)((w32 >> (20 - bits)) & mask_v) + 11;
            consume(12 + bits);
          } else {                       // (e << k) | the k mantissa bits
            v = (int)__funnelshift_l(rest, (unsigned)e, (unsigned)k);
            consume(e + 1 + k);
          }
          // the symbol, sign-flipped by the drift; the residual
          const int sv = (v >> 1) ^ -(v & 1) ^ ((2 * row.x + row.w) >> 31);
          int x_res = sv + row.z;        // folded to `bits` by the mask below
          if (ended) {
            x_res = ((x_res + half) & mask_v) - half;
            if (x_res >= 0) ++x_res;
          }
          if constexpr ((STAGES & STAGE_VLC) != 0) {
            last_row = update_vlc(row, sv);
            last_k = vlc_k(last_row.w, last_row.y);
            last_c = c;
            st[c] = last_row;
            k_s[c] = (uint8_t)last_k;
          }
          const int val =
              ((pred + (ctx < 0 ? -x_res : x_res) + wrap) & mask_v) - wrap;
          cur[x] = val;
          LT = T;
          LL = Lv;
          Lv = val;
          ++x;
        }
        wi_s[0] = wi;
      }
      __syncwarp();
      for (int x = t; x < w; x += 32) out_p[y * w + x] = cur[x];
      int32_t* tmp = cur;
      cur = prev;
      prev = tmp;
      __syncwarp();
    }
  }
  if (t == 0) bitpos_out[lane] = 32 * wi - nb;
  if (!GTAB) {
    int4* dst = reinterpret_cast<int4*>(vlc_out) + (size_t)lane * CC;
    for (int i = t; i < CC; i += 32) dst[i] = st[i];
  }
}

// the ring's words for planes at most wmax wide: a power of two above a
// row's words
static int ring_words(int wmax) {
  int rw = 1;
  while (rw < row_words(wmax) + 2) rw <<= 1;
  return rw;
}

template <bool FIVE, bool GTAB, int STAGES>
static int launch(const void* bufs, int cap, const void* vlc0, const void* qt,
                  const void* pos0, const PlaneSpecs& specs, void* out,
                  int out_stride, void* bitpos_out, void* vlc_out, int L,
                  int CC, int bits, int wmax, cudaStream_t stream) {
  const int RW = ring_words(wmax);
  const size_t smem = (GTAB ? 0 : (size_t)CC * 16) + (FIVE ? 5 : 3) * 1024 +
                      (size_t)RW * 4 + 16 * (size_t)(wmax + 1) + 16 +
                      (size_t)CC;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        golomb_decode_kernel<FIVE, GTAB, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  golomb_decode_kernel<FIVE, GTAB, STAGES><<<L, 32, smem, stream>>>(
      (const uint8_t*)bufs, cap, (const int32_t*)vlc0, (const int32_t*)qt,
      (const int32_t*)pos0, specs, (int32_t*)out, out_stride,
      (int32_t*)bitpos_out, (int32_t*)vlc_out, CC, bits, wmax, RW);
  return (int)cudaGetLastError();
}

// Plain C entry point: returns the cudaError_t of the launch (0 = ok).  spec
// is a host array of nplanes x (w, h, pbase) triples; plane k's samples start
// at column sum_{j<k} w_j * h_j of the (L, out_stride) out.  five != 0
// selects the 5-input context (qt holds five tables); gtab != 0 the
// table-in-global-memory instance, where vlc_out must hold a copy of vlc0.
// golomb_decode_stages_launch takes the same arguments and the STAGES kept.
#define GOLOMB_DEC_PARAMS                                                  \
  const void *bufs, int cap, const void *vlc0, const void *qt,             \
      const void *pos0, const int *spec, int nplanes, void *out,           \
      int out_stride, void *bitpos_out, void *vlc_out, int L, int CC,      \
      int bits, int five, int gtab

template <int STAGES>
static int launch_any(GOLOMB_DEC_PARAMS, void* stream) {
  if (nplanes < 1 || nplanes > MAX_PLANES || bits < 1 || bits > 16)
    return (int)cudaErrorInvalidValue;
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
#define GOLOMB_DEC_ARGS                                                     \
  bufs, cap, vlc0, qt, pos0, specs, out, out_stride, bitpos_out, vlc_out, L, \
      CC, bits, wmax, s
  return five ? (gtab ? launch<true, true, STAGES>(GOLOMB_DEC_ARGS)
                      : launch<true, false, STAGES>(GOLOMB_DEC_ARGS))
              : (gtab ? launch<false, true, STAGES>(GOLOMB_DEC_ARGS)
                      : launch<false, false, STAGES>(GOLOMB_DEC_ARGS));
#undef GOLOMB_DEC_ARGS
}

#define GOLOMB_DEC_FWD                                                     \
  bufs, cap, vlc0, qt, pos0, spec, nplanes, out, out_stride, bitpos_out,   \
      vlc_out, L, CC, bits, five, gtab, stream

extern "C" int golomb_decode_launch(GOLOMB_DEC_PARAMS, void* stream) {
  return launch_any<ALL_STAGES>(GOLOMB_DEC_FWD);
}

extern "C" int golomb_decode_stages_launch(GOLOMB_DEC_PARAMS, int stages,
                                           void* stream) {
  switch (stages) {
    case ALL_STAGES:
      return launch_any<ALL_STAGES>(GOLOMB_DEC_FWD);
    case ALL_STAGES & ~STAGE_WINDOW:
      return launch_any<ALL_STAGES & ~STAGE_WINDOW>(GOLOMB_DEC_FWD);
    case ALL_STAGES & ~STAGE_CTX:
      return launch_any<ALL_STAGES & ~STAGE_CTX>(GOLOMB_DEC_FWD);
    case ALL_STAGES & ~STAGE_VLC:
      return launch_any<ALL_STAGES & ~STAGE_VLC>(GOLOMB_DEC_FWD);
    case ALL_STAGES & ~STAGE_RECON:
      return launch_any<ALL_STAGES & ~STAGE_RECON>(GOLOMB_DEC_FWD);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
