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
// (about half a byte in and 4 out per pixel); each pixel's context, so its
// VlcState row, needs the value the pixel before decoded, and its bit window
// the position that pixel's symbol ended at.
//
// What the design does about it (a first version, simple and exact):
//
// - Every thread runs the chain redundantly (the values are identical, so
//   every branch is warp-uniform); the VlcState row is one 16-byte load and
//   one store.
// - The bit window: the slice's bytes as 128-byte blocks in a 512-byte ring
//   in shared memory, refilled one block ahead from global memory (K2's
//   ring), so no global load waits on the chain; a read takes the 5 bytes at
//   bitpos >> 3 from the ring.  A pixel reads at most 7 bytes and a 4-byte
//   window past them, so the two blocks in the ring cover it.
// - A row-parallel context: at each row's start the warp computes, 32 columns
//   at a time, the part of every pixel's context that does not depend on the
//   row being decoded (LT - T, T - RT; FIVE: TT - T, TT the stale entry of
//   the 2-row ring, row y-2); the chain adds L's terms (L - LT; FIVE: LL - L).
// - The Golomb parameter k, ff_log2_run and the VlcState update are G1's
//   (csrc/golomb_vlc.cuh).
//
// Table placement: the lane's VLC table (CC rows of 16 B: 21,312 B at context
// model 0), the quant tables (three, FIVE: five), the byte ring, two
// reconstructed rows and the row's (T, context part) pairs live in shared
// memory.  Context model 1's table (2 x 7,563 rows, 242,016 B) does not fit a
// block: the GTAB instance keeps it in global memory, adapted in place in
// vlc_out, which the wrapper fills with vlc0; the chain code is the same.
// The context index is clamped so damaged streams stay inside the table.
#include <cuda_runtime.h>
#include <stdint.h>

#include "golomb_vlc.cuh"  // log2_run, vlc_k, update_vlc

#define MAX_PLANES 4

struct PlaneSpecs {
  int n;
  int w[MAX_PLANES], h[MAX_PLANES], pbase[MAX_PLANES], off[MAX_PLANES];
};

template <bool FIVE, bool GTAB>
__global__ void __launch_bounds__(32) golomb_decode_kernel(
    const uint8_t* __restrict__ bufs, int cap,
    const int32_t* __restrict__ vlc0, const int32_t* __restrict__ qt,
    const int32_t* __restrict__ pos0, PlaneSpecs specs,
    int32_t* __restrict__ out, int out_stride,
    int32_t* __restrict__ bitpos_out, int32_t* __restrict__ vlc_out, int CC,
    int bits, int wmax) {
  constexpr int NQ = FIVE ? 5 : 3;               // quant tables read
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  // CC x 4 VLC table: shared memory, or the lane's rows of vlc_out
  int4* st = GTAB ? reinterpret_cast<int4*>(vlc_out) + (size_t)lane * CC
                  : reinterpret_cast<int4*>(smem);
  int32_t* qt_s = reinterpret_cast<int32_t*>(smem + (GTAB ? 0 : CC * 16));
  uint32_t* ring = reinterpret_cast<uint32_t*>(qt_s + NQ * 256);  // 512 B
  const uint8_t* ring_b = reinterpret_cast<const uint8_t*>(ring);
  int2* tc_s = reinterpret_cast<int2*>(ring + 128);   // (T, ctx part)
  int32_t* rowA = reinterpret_cast<int32_t*>(tc_s + (wmax + 1));
  int32_t* rowB = rowA + (wmax + 1);

  if (!GTAB) {
    const int4* src = reinterpret_cast<const int4*>(vlc0) + (size_t)lane * CC;
    for (int i = t; i < CC; i += 32) st[i] = src[i];
  }
  // quant tables 0, 1, 2 (FIVE: and 3, 4)
  for (int i = t; i < NQ * 256; i += 32) qt_s[i] = qt[i];

  const uint8_t* buf = bufs + (size_t)lane * cap;
  // word i of the lane's bytes (0 past cap), by bytes: cap need not be a
  // multiple of 4
  auto word = [&](int i) -> uint32_t {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * i + k;
      v |= (uint32_t)(j < cap ? buf[j] : 0) << (8 * k);
    }
    return v;
  };
  int bp = pos0[lane] * 8;               // the bit position
  // the bytes as 128-byte blocks in a ring of four: blocks blk and blk + 1
  // (every byte a pixel can read) are in the ring, block blk + 2 in flight
  // in `pending`, thread t holding its word t
  int blk = bp >> 10;
  ring[(blk & 3) * 32 + t] = word(blk * 32 + t);
  ring[((blk + 1) & 3) * 32 + t] = word((blk + 1) * 32 + t);
  uint32_t pending = word((blk + 2) * 32 + t);
  // the 32 bits at bit position p, MSB first
  auto peek = [&](int p) -> uint32_t {
    const int b = p >> 3;
    unsigned long long w = 0;
#pragma unroll
    for (int k = 0; k < 5; ++k) w = (w << 8) | ring_b[(b + k) & 511];
    return (uint32_t)(w >> (8 - (p & 7)));
  };
  const int mask_v = (1 << bits) - 1, half = 1 << (bits - 1);
  int32_t* out_l = out + (size_t)lane * out_stride;
  __syncwarp();

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
      // row borders: L at x = 0 is the previous row's first sample, LT the
      // first sample of the row before that
      int Lv = prev[0];
      int LT = cur[0];
      int LL = 0;
      int run_mode = 0, run_count = 0;
      __syncwarp();
      for (int x = 0; x < w; ++x) {
        if ((bp >> 10) != blk) {         // a new block: keep one ahead
          ring[((blk + 2) & 3) * 32 + t] = pending;
          pending = word((blk + 3) * 32 + t);
          ++blk;
          __syncwarp();
        }
        const int2 tc = tc_s[x];
        const int T = tc.x;
        int ctx = tc.y + qt_s[(Lv - LT) & 0xFF];
        if (FIVE) ctx += qt_s[768 + ((LL - Lv) & 0xFF)];
        const bool csign = ctx < 0;
        if (csign) ctx = -ctx;
        // run mode (ffv1dec.c:139-170)
        if (ctx == 0 && run_mode == 0) run_mode = 1;
        const bool in_run = run_mode > 0;
        bool ended = false;
        if (in_run) {
          if (run_count == 0 && run_mode == 1) {
            const int lr = log2_run(run_index);
            if (peek(bp) >> 31) {        // a full run chunk
              run_count = 1 << lr;
              if (x + run_count <= w) ++run_index;
            } else {                     // a short run: lr bits of length
              run_count = lr ? (int)(peek(bp + 1) >> (32 - lr)) : 0;
              bp += lr;
              if (run_index > 0) --run_index;
              run_mode = 2;
            }
            bp += 1;
          }
          if (--run_count < 0) {
            ended = true;
            run_mode = 0;
            run_count = 0;
          }
        }
        int diff = 0;
        if (!in_run || ended) {          // get_vlc_symbol
          int4* rowp = st + min(ctx + pbase, CC - 1);
          const int4 row = *rowp;
          const int drift = row.x, esum = row.y, bias = row.z, count = row.w;
          const int k = vlc_k(count, esum);
          const uint32_t w32 = peek(bp);
          const int e = __clz((int)w32);
          int v;
          if (e >= 12) {                 // escape: limit 12, esc_len = bits
            v = (int)((w32 >> (20 - bits)) & mask_v) + 11;
            bp += 12 + bits;
          } else {
            const int nb = e + 1 + k;
            v = (e << k) | (int)((w32 >> (32 - nb)) & ((1u << k) - 1));
            bp += nb;
          }
          int sv = (v >> 1) ^ -(v & 1);
          if (2 * drift + count < 0) sv = ~sv;
          diff = ((sv + bias + half) & mask_v) - half;
          const int4 nrow = update_vlc(row, sv);
          // every thread read the row before any writes it (each thread writes
          // the same values, and reads back what it wrote)
          __syncwarp();
          *rowp = nrow;
          if (ended && diff >= 0) ++diff;
        }
        if (csign) diff = -diff;
        const int m = Lv + T - LT;
        const int pred = Lv + m + T - min(min(Lv, m), T) -
                         max(max(Lv, m), T);
        int val = (pred + diff) & mask_v;
        // int16_t sample rows at 16 bits: the median compares them signed
        if (bits == 16) val = ((val + 0x8000) & 0xFFFF) - 0x8000;
        cur[x] = val;
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
  if (t == 0) bitpos_out[lane] = bp;
  if (!GTAB) {
    int4* dst = reinterpret_cast<int4*>(vlc_out) + (size_t)lane * CC;
    for (int i = t; i < CC; i += 32) dst[i] = st[i];
  }
}

template <bool FIVE, bool GTAB>
static int launch(const void* bufs, int cap, const void* vlc0, const void* qt,
                  const void* pos0, const PlaneSpecs& specs, void* out,
                  int out_stride, void* bitpos_out, void* vlc_out, int L,
                  int CC, int bits, int wmax, cudaStream_t stream) {
  const size_t smem = (GTAB ? 0 : (size_t)CC * 16) + (FIVE ? 5 : 3) * 1024 +
                      512 + 4 * (size_t)(wmax + 1) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        golomb_decode_kernel<FIVE, GTAB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  golomb_decode_kernel<FIVE, GTAB><<<L, 32, smem, stream>>>(
      (const uint8_t*)bufs, cap, (const int32_t*)vlc0, (const int32_t*)qt,
      (const int32_t*)pos0, specs, (int32_t*)out, out_stride,
      (int32_t*)bitpos_out, (int32_t*)vlc_out, CC, bits, wmax);
  return (int)cudaGetLastError();
}

// Plain C entry point: returns the cudaError_t of the launch (0 = ok).  spec
// is a host array of nplanes x (w, h, pbase) triples; plane k's samples start
// at column sum_{j<k} w_j * h_j of the (L, out_stride) out.  five != 0
// selects the 5-input context (qt holds five tables); gtab != 0 the
// table-in-global-memory instance, where vlc_out must hold a copy of vlc0.
extern "C" int golomb_decode_launch(const void* bufs, int cap,
                                    const void* vlc0, const void* qt,
                                    const void* pos0, const int* spec,
                                    int nplanes, void* out, int out_stride,
                                    void* bitpos_out, void* vlc_out, int L,
                                    int CC, int bits, int five, int gtab,
                                    void* stream) {
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
  return five ? (gtab ? launch<true, true>(GOLOMB_DEC_ARGS)
                      : launch<true, false>(GOLOMB_DEC_ARGS))
              : (gtab ? launch<false, true>(GOLOMB_DEC_ARGS)
                      : launch<false, false>(GOLOMB_DEC_ARGS));
#undef GOLOMB_DEC_ARGS
}
