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
// What bounds it on the H100: the serial chain, one lane per warp and one
// warp per SM (L = 48 of the 132 SMs on the 1080p main path).  Each decision
// needs the previous one's low/range, and each pixel's context, so its state
// row and its first decision, needs the value the pixel before decoded.
// Bytes are few (~1.3 per pixel in, 4 out), so a pixel costs its decisions'
// latency plus what its one warp issues in order between them and between
// the last decision of one pixel and the first of the next.
//
// What the design does about it:
//
// - Nothing between two decisions that can wait.  Every thread runs the
//   chain redundantly (the values are identical, so every branch is
//   warp-uniform) and holds the pixel's whole state row in registers (two
//   broadcast 16-byte loads).  The zero flag and the exponent run are
//   unrolled, left by one uniform branch, their states constant byte
//   extracts; the mantissa's and the sign's states depend on the exponent
//   and are gathered during the run (each step that continues shifts the
//   next mantissa state into a packed register and takes the next sign
//   state), so they are ready when it ends.  Damaged streams keep their
//   shape: e reaches E_MAX + 1 with no stop decision, and the mantissa then
//   has E_MAX decisions at rows 22 + e - 1 - j.
// - No branch on the thread: in each decision the owner of its position
//   takes the successor its bit picks by a select; after the pixel every
//   thread stores its byte.  Both successors of a thread's byte come from
//   one 16-bit lookup right after the row read, off the chain.
// - The refill byte: at a pixel's start thread t holds byte pos + t of the
//   slice (its worst case, 2 * bits + 1 bytes, fits a warp) from a ring of
//   the slice's bytes in shared memory, and a renormalisation takes its
//   byte by shuffle from lane pos - pos0.  The ring holds four 128-byte
//   blocks and is refilled one block ahead from global memory, so no global
//   load waits on the chain; reads at pos >= cap give 0.
// - A row-parallel context: at each row's start the warp computes, 32
//   columns at a time, the part of every pixel's context that does not
//   depend on the row being decoded (LT - T, T - RT; FIVE: TT - T).  L's
//   terms (FIVE: and LL's) are looked up in the pixel before, for each
//   value it can take (pred, pred + a, pred - a) before the decision that
//   picks one, together with the next pixel's row index and context sign,
//   so after the sign decision a select picks the next row.
//
// Deferred adaptation is valid because at bits <= 10 the positions a pixel
// touches are pairwise distinct.  Thread t writes only byte t of a row but
// every thread reads every byte: one __syncwarp orders every thread's row
// read before the stores, another the stores before the next pixel's read.
//
// Time against the design before it (thread t reading only byte t, states by
// shuffle between decisions, a branch on the thread in each decision, the
// context and the transition lookup on the pixel-to-pixel path, the refill
// window reloaded from global memory on the chain), in one call on the 1080p
// main path's warm-up inputs, NVIDIA H100 80GB HBM3 at 700 W: 29.14 against
// 57.48 ms (`rc_decode`), 42.25 against 72.59 (`rc_decode_five_global`),
// 29.66 against 58.83 (5-input context, table in shared memory) and 34.16
// against 62.81 (3-input, table in global memory).  Tried and dropped on the
// same inputs (PERF.md): the refill byte from a queue of 32-bit words in
// registers, shifted by funnel shifts on a renormalisation (exact, 1.35 ms
// slower: five more instructions per decision, and a dependent decision in
// that form no faster); the decided positions and bits as two masks
// over the row, computed after the pixel (1.4 ms slower than the owner's
// select); L's terms looked up after the value, not for each candidate
// (0.9 ms); the next pixel's row index computed after its value, not for each
// candidate (0.7 ms; 3.8 ms faster in the 3-input instance with the table in
// global memory, which no main path runs).
//
// Table placement: the lane's state table (CC x 32 B, 42,624 B on the main
// path), the transition pairs, the quant tables (three, FIVE: five), the
// byte ring, two reconstructed rows (previous and current, w + 1 int32 each)
// and the row's (T, context part) pairs live in shared memory.  Context
// model 1's table (2 x 7,563 rows at 8 bits, 484,032 B) does not fit a
// block: the GTAB instance keeps it in global memory instead, adapted in
// place in states_out, which the wrapper fills with states0 (L2-resident:
// 23.2 MB for 48 lanes); the chain code is the same, only where `st` points
// differs, and the wrapper picks the instance from the table's size.  FIVE
// adds TT, the stale cur[x] of the 2-row ring (row y-2, zeros for y < 2
// since the rows are zeroed per plane), read in the row pass before the row
// overwrites it, and LL, the previous pixel's L (0 at x = 0).  The context
// index is clamped so damaged streams stay inside the table.
//
// RGB (B1: this kernel with RGB = true, reached through
// rc_decode_rgb_launch at coded widths 9 (bgr0, bgra) and 10 (gbrp9); it
// replaces the XLA scan tpu_ffv1/tpu/dec_scan_lanes.py:266
// rc_decode_rgb_lanes, ffv1dec.c:226-255): each row of a slice decodes a
// line of every plane G, B, R(, A) in turn from the one coder, plane p on
// state plane (p + 1) / 2 (its pbase), each plane from its own 2-row ring.
// The per-pixel code is the planar kernel's; only the line order and the
// rings differ.  The rings are zeroed once per slice, not per plane: a
// plane's row y-1 is the line it decoded P lines before.  The row pass
// (LT - T, T - RT; FIVE: TT - T with TT the stale cur[x], row y-2 of the
// same plane) runs once per line, from that plane's ring, before the line
// overwrites it.  Shared memory holds 2P ring rows instead of two.
//
// B1's redesign began with its stage split (the LINE probe below) and a
// count of its pixel loop's SASS (PERF.md): its time follows the bytes its
// coders read, every stub that saved time read fewer bytes, the line loop
// (810 row passes a lane on the rgb8 path) showed no cost of its own, and
// the loop issues about 24 SASS instructions a decision (the chain probe's
// decision 17.5).  What was kept is in the loop it shares with K2: each
// decision's owner test is a compare with a constant (the mantissa's
// positions through jt = 21 + e - t, computed once a pixel), an
// instruction fewer in each mantissa decision.  In one call on the warm-up
// inputs (tools/scan_variants.py, NVIDIA H100 80GB HBM3 at 700 W), against
// the design before it: 65.52 against 65.91 ms (B1, rgb8), 28.63 against
// 28.89 (K2, 8bit), 42.18 against 42.48 (K2-five, table in global memory).
// Tried and dropped on the same inputs, each exact, ms against the design
// before it in the same call (PERF.md): the next pixel's row read ahead
// for each value the pixel can take (the zero symbol's at the pixel's
// start, pred +- a's before the sign decision) and read again only where
// it is the pixel's own row, with the refill window kept across pixels
// (81.70 against 65.97; K2 37.48 against 28.90, K2-five 67.73 against
// 42.61), and with the thread's own byte taken from the registers and its
// adaptation picked after the pixel (84.04 against 65.80); only the row's
// first word read ahead (77.85 against 65.97); the refill window kept
// across pixels (71.91 against 65.44 with the owner tests); the owner's
// decision kept as 0, 1 or 2 and its byte picked after the pixel (65.94
// against 65.63); the shuffle's source kept as the count of bytes the
// pixel read (67.62 against 65.52).  Every read ahead lost; a load among
// the decisions may delay their shuffles, which use the same memory pipe
// (not measured apart).
//
// Stage probes (STAGES != ALL_STAGES, reached through
// rc_decode_stages_launch, K2 at 8 bits, and rc_decode_rgb_stages_launch,
// B1 at 9 bits, never by the codec): the same kernel with one stage
// stubbed, for timing only (their outputs are wrong on purpose).
// CTX: the context index from the decoded neighbours (stubbed: from the
// pixel's column, which cuts the val -> context -> row dependency between
// pixels; the context's sign stays live); READ: the row read (stubbed: the
// states constants, and the thread's own byte a per-thread constant); TRANS:
// the transition lookup (stubbed: the state stays); WRITE: the adaptation
// store; REFILL: the renormalisation byte and the ring (stubbed: a constant
// byte, no reload); CHAIN: the low/range arithmetic (stubbed: each bit a
// fixed function of its state, so the loops keep their shape); LINE (B1's
// probes only): the row pass and the row's output stores (stubbed: every
// (T, context part) pair stays 0, nothing is written to out).  The
// production instances are ALL_STAGES.
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define MAX_PLANES 4

enum : int {
  STAGE_CTX = 1,
  STAGE_READ = 2,
  STAGE_TRANS = 4,
  STAGE_WRITE = 8,
  STAGE_REFILL = 16,
  STAGE_CHAIN = 32,
  STAGE_LINE = 64,
  ALL_STAGES = 127
};

struct PlaneSpecs {
  int n;
  int w[MAX_PLANES], h[MAX_PLANES], pbase[MAX_PLANES], off[MAX_PLANES];
};

template <int BITS, bool FIVE, bool GTAB, bool RGB, int STAGES>
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
  constexpr int MASK_V = (1 << BITS) - 1;
  constexpr int NQ = FIVE ? 5 : 3;               // quant tables read
  constexpr int PW = (E_MAX + 3) / 4 > 0 ? (E_MAX + 3) / 4 : 1;
  constexpr bool CTX = (STAGES & STAGE_CTX) != 0;
  constexpr bool READ = (STAGES & STAGE_READ) != 0;
  constexpr bool TRANS = (STAGES & STAGE_TRANS) != 0;
  constexpr bool WRITE = (STAGES & STAGE_WRITE) != 0;
  constexpr bool REFILL = (STAGES & STAGE_REFILL) != 0;
  constexpr bool CHAIN = (STAGES & STAGE_CHAIN) != 0;
  constexpr bool LINE = (STAGES & STAGE_LINE) != 0;
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  // CC x 32 state table: shared memory, or the lane's rows of states_out
  uint8_t* st = GTAB ? states_out + (size_t)lane * CC * 32 : smem;
  int32_t* qt_s = reinterpret_cast<int32_t*>(smem + (GTAB ? 0 : CC * 32));
  uint32_t* ring = reinterpret_cast<uint32_t*>(qt_s + NQ * 256);  // 512 B
  uint16_t* oz_s = reinterpret_cast<uint16_t*>(ring + 128);       // 512 B
  int2* tc_s = reinterpret_cast<int2*>(oz_s + 256);   // (T, ctx part)
  // the 2-row rings of reconstructed samples: one, or with RGB one per
  // plane
  int32_t* rings = reinterpret_cast<int32_t*>(tc_s + (wmax + 1));

  if (!GTAB) {
    const uint4* src = reinterpret_cast<const uint4*>(
        states0 + (size_t)lane * CC * 32);
    for (int i = t; i < CC * 2; i += 32)
      reinterpret_cast<uint4*>(st)[i] = src[i];
  }
  for (int i = t; i < NQ * 256; i += 32) qt_s[i] = qt[i];
  // both successors of a state in one lookup: one_tab low, zero_tab high
  for (int i = t; i < 256; i += 32)
    oz_s[i] = (uint16_t)(one_tab[i] | (zero_tab[i] << 8));

  const uint8_t* buf = bufs + (size_t)lane * cap;
  // word i of the lane's bytes (0 past cap), by bytes: cap need not be a
  // multiple of 4
  auto word = [&](int i) -> uint32_t {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * i + k;
      v |= (uint32_t)(j < cap ? __ldg(buf + j) : 0) << (8 * k);
    }
    return v;
  };
  int low = low0[lane], rng = range0[lane], pos = pos0[lane];
  // the bytes as 128-byte blocks in a ring of four: blocks blk and blk + 1
  // (every byte a pixel can read from pos) are in the ring, block blk + 2
  // in flight in `pending`, thread t holding its word t
  int blk = pos >> 7;
  ring[(blk & 3) * 32 + t] = word(blk * 32 + t);
  ring[((blk + 1) & 3) * 32 + t] = word((blk + 1) * 32 + t);
  uint32_t pending = word((blk + 2) * 32 + t);
  int32_t* out_l = out + (size_t)lane * out_stride;
  __syncwarp();

  // planar: the planes one after the other, each from zeroed rows.  RGB
  // (line-interleaved, ffv1dec.c:226-255): all planes have the slice's
  // size, row y decodes a line of every plane in order, and each plane's
  // ring, zeroed once per slice, carries from its row y-1 to its row y
  const int nring = RGB ? specs.n : 1;
  for (int pl = 0; pl < (RGB ? 1 : specs.n); ++pl) {
    const int w = specs.w[pl], h = specs.h[pl];
    const int pbase_pl = specs.pbase[pl];
    int32_t* out_pl = out_l + specs.off[pl];
    for (int i = t; i <= wmax; i += 32) {
      for (int r = 0; r < 2 * nring; ++r) rings[r * (wmax + 1) + i] = 0;
      tc_s[i] = make_int2(0, 0);     // [w] is read ahead and never used
    }
    __syncwarp();
    int32_t* cur = rings;
    int32_t* prev = rings + (wmax + 1);
    for (int yl = 0; yl < h * nring; ++yl) {
      // line yl: row y of plane p (planar: the plane's row yl)
      const int y = RGB ? yl / nring : yl;
      const int p = RGB ? yl - y * nring : pl;
      const int pbase = RGB ? specs.pbase[p] : pbase_pl;
      int32_t* out_p = RGB ? out_l + specs.off[p] : out_pl;
      if constexpr (RGB) {        // the plane's ring
        cur = rings + (2 * p + (y & 1)) * (wmax + 1);
        prev = rings + (2 * p + (~y & 1)) * (wmax + 1);
      }
      // the part of each pixel's context that does not depend on the row
      // being decoded, 32 columns at a time: LT - T and T - RT (FIVE: TT
      // - T, TT the stale cur[x] of the 2-row ring, row y-2); LT at x = 0
      // is the stale cur[0] (ffv1dec.c:202-203)
      for (int x = t; LINE && x < w; x += 32) {
        const int T = prev[x];
        const int LT = x > 0 ? prev[x - 1] : cur[0];
        const int RT = prev[min(x + 1, w - 1)];
        int cp = qt_s[256 + ((LT - T) & 0xFF)] +
                 qt_s[512 + ((T - RT) & 0xFF)];
        if (FIVE) cp += qt_s[1024 + ((cur[x] - T) & 0xFF)];
        tc_s[x] = make_int2(T, cp);
      }
      // row borders: L at x=0 is the previous row's first sample, LT the
      // first sample of the row before that
      int Lv = prev[0];
      int LT = cur[0];
      int LL = 0;
      __syncwarp();
      int2 tc = tc_s[0];
      // a context's row index and sign from its part cp and L's terms q
      auto place = [&](int cp, int q, int& ci, bool& cs) {
        const int c = cp + q;
        cs = c < 0;
        ci = min(max((cs ? -c : c) + pbase, 0), CC - 1);
      };
      // the pixel's row and context sign (for x > 0 placed in the pixel
      // before, for each value that pixel could take)
      int cin;
      bool csn;
      place(tc.y, qt_s[(Lv - LT) & 0xFF] +
                      (FIVE ? qt_s[768 + ((LL - Lv) & 0xFF)] : 0),
            cin, csn);
      for (int x = 0; x < w; ++x) {
        const int T = tc.x;
        const int2 tc_n = tc_s[x + 1];   // the next pixel's, ahead
        // the refill bytes: thread t holds byte pos + t, from the ring
        int wb = 0;
        const int p0 = pos;
        if constexpr (REFILL) {
          if ((pos >> 7) != blk) {         // a new block: keep one ahead
            ring[((blk + 2) & 3) * 32 + t] = pending;
            pending = word((blk + 3) * 32 + t);
            ++blk;
            __syncwarp();
          }
          wb = reinterpret_cast<const uint8_t*>(ring)[(pos + t) & 511];
        }
        const bool csign = csn;
        const int ci = CTX ? cin : min(x + pbase, CC - 1);
        uint8_t* row = st + ci * 32;
        // the row: every thread all 32 states (two broadcast 16-byte
        // loads), and its own byte with both successors
        uint32_t R[8];
        int mys;
        if constexpr (READ) {
          const uint4 r0 = reinterpret_cast<const uint4*>(row)[0];
          const uint4 r1 = reinterpret_cast<const uint4*>(row)[1];
          R[0] = r0.x; R[1] = r0.y; R[2] = r0.z; R[3] = r0.w;
          R[4] = r1.x; R[5] = r1.y; R[6] = r1.z; R[7] = r1.w;
          mys = row[t];
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) R[k] = 0x80706050u + 0x01010101u * k;
          mys = 64 + 4 * t;
        }
        const int oz = TRANS ? oz_s[mys] : mys | (mys << 8);
        const int up = oz & 0xFF, dn = oz >> 8;
        int nb = mys;                      // this thread's adapted byte
        auto sb = [&](int i) -> int {    // state byte i of the row
          return (int)__byte_perm(R[i >> 2], 0, 0x4440 | (i & 3));
        };
        const int m2 = Lv + T - LT;
        const int pred = Lv + m2 + T - min(min(Lv, m2), T) -
                         max(max(Lv, m2), T);
        // the next pixel's L terms for a value v: qt0[v - T] (FIVE: and
        // qt3[Lv - v]), looked up before the decision that picks v
        auto lterms = [&](int v) -> int {
          int q = qt_s[(v - T) & 0xFF];
          if (FIVE) q += qt_s[768 + ((Lv - v) & 0xFF)];
          return q;
        };
        int val = pred & MASK_V;          // a zero symbol
        place(tc_n.y, lterms(val), cin, csn);

        // one decision; the owner thread of its row position (``own``)
        // takes the successor its bit picks
        auto decide = [&](int s, bool own) -> int {
          int bit;
          if constexpr (CHAIN) {
            const int r1 = (rng * s) >> 8;
            const int r0 = rng - r1;
            bit = low >= r0;
            low = bit ? low - r0 : low;
            rng = bit ? r1 : r0;
            const bool need = rng < 0x100;
            const int nxt =
                REFILL ? __shfl_sync(FULL_MASK, wb, pos - p0) : 0x5A;
            low = need ? (low << 8) | nxt : low;
            rng = need ? rng << 8 : rng;
            pos += need;
          } else {
            bit = ((unsigned)s * 0x9E3779B1u) >> 31;
          }
          nb = own ? (bit ? up : dn) : nb;
          return bit;
        };
        if (!decide(sb(0), t == 0)) {     // nonzero symbol
          int e = 0;
          // P: the mantissa's states in coding order for the run so far
          // (byte j = row[21 + e - j]); ss: the sign's, row[11 + e]
          uint32_t P[PW];
#pragma unroll
          for (int k = 0; k < PW; ++k) P[k] = 0;
          int ss = sb(11);
          // unary exponent + stop; e reaches E_MAX + 1 only on damaged
          // streams, with no stop decision
#pragma unroll
          for (int k = 1; k <= E_MAX + 1; ++k) {
            if (!decide(sb(k), t == k)) break;
            e = k;
#pragma unroll
            for (int i = PW - 1; i > 0; --i)
              P[i] = __byte_perm(P[i], P[i - 1], 0x2107);
            P[0] = __byte_perm(P[0], R[(21 + k) >> 2],
                               0x2104 + ((21 + k) & 3));
            ss = sb(11 + min(k, 10));
          }
          // mantissa: min(e, E_MAX) decisions, MSB first, decision j at
          // row position 21 + e - j (thread t's: jt)
          const int m = min(e, E_MAX);
          const int jt = 21 + e - t;
          int a = 1;
#pragma unroll
          for (int j = 0; j < E_MAX; ++j) {
            if (j == m) break;
            a = 2 * a + decide((int)__byte_perm(P[j >> 2], 0,
                                                 0x4440 | (j & 3)),
                               jt == j);
          }
          const int vp = (pred + a) & MASK_V, vm = (pred - a) & MASK_V;
          int cip, cim;
          bool csp, csm;
          place(tc_n.y, lterms(vp), cip, csp);
          place(tc_n.y, lterms(vm), cim, csm);
          const int sbit = decide(ss, t == 11 + e);
          const bool neg = sbit != (int)csign;
          val = neg ? vm : vp;
          cin = neg ? cim : cip;
          csn = neg ? csm : csp;
        }
        // each thread stores its byte of the row, adapted where the pixel
        // decided at its position: after every thread's row read, before
        // the next pixel's
        __syncwarp();
        if constexpr (WRITE) row[t] = (uint8_t)nb;
        __syncwarp();
        cur[x] = val;
        LT = T;
        LL = Lv;
        Lv = val;
        tc = tc_n;
      }
      __syncwarp();
      for (int x = t; LINE && x < w; x += 32) out_p[y * w + x] = cur[x];
      if constexpr (!RGB) {
        int32_t* tmp = cur;
        cur = prev;
        prev = tmp;
      }
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

template <int BITS, bool FIVE, bool GTAB, int STAGES, bool RGB = false>
static int launch(const void* bufs, int cap, const void* states0,
                  const void* one_tab, const void* zero_tab, const void* qt,
                  const void* low0, const void* range0, const void* pos0,
                  const PlaneSpecs& specs, void* out, int out_stride,
                  void* low_out, void* range_out, void* pos_out,
                  void* states_out, int L, int CC, int wmax,
                  cudaStream_t stream) {
  const size_t smem = (GTAB ? 0 : (size_t)CC * 32) +
                      (FIVE ? 5 : 3) * 256 * 4 + 512 + 512 +
                      (2 + 2 * (RGB ? specs.n : 1)) * (size_t)(wmax + 1) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rc_decode_kernel<BITS, FIVE, GTAB, RGB, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rc_decode_kernel<BITS, FIVE, GTAB, RGB, STAGES><<<L, 32, smem, stream>>>(
      (const uint8_t*)bufs, cap, (const uint8_t*)states0,
      (const uint8_t*)one_tab, (const uint8_t*)zero_tab, (const int32_t*)qt,
      (const int32_t*)low0, (const int32_t*)range0, (const int32_t*)pos0,
      specs, (int32_t*)out, out_stride, (int32_t*)low_out,
      (int32_t*)range_out, (int32_t*)pos_out, (uint8_t*)states_out, CC,
      wmax);
  return (int)cudaGetLastError();
}

#define RC_DEC_PARAMS                                                      \
  const void *bufs, int cap, const void *states0, const void *one_tab,     \
      const void *zero_tab, const void *qt, const void *low0,              \
      const void *range0, const void *pos0, const int *spec, int nplanes,  \
      void *out, int out_stride, void *low_out, void *range_out,           \
      void *pos_out, void *states_out, int L, int CC
#define RC_DEC_ARGS                                                        \
  bufs, cap, states0, one_tab, zero_tab, qt, low0, range0, pos0, specs,   \
      out, out_stride, low_out, range_out, pos_out, states_out, L, CC,    \
      wmax, s

// The plane table of a launch; false if it does not fit out's stride.
static bool plane_specs(const int* spec, int nplanes, int out_stride,
                        PlaneSpecs& specs, int& wmax) {
  if (nplanes < 1 || nplanes > MAX_PLANES) return false;
  specs.n = nplanes;
  int off = 0;
  wmax = 1;
  for (int k = 0; k < nplanes; ++k) {
    specs.w[k] = spec[3 * k];
    specs.h[k] = spec[3 * k + 1];
    specs.pbase[k] = spec[3 * k + 2];
    specs.off[k] = off;
    off += specs.w[k] * specs.h[k];
    wmax = specs.w[k] > wmax ? specs.w[k] : wmax;
  }
  return off <= out_stride;
}

// Whether every plane of a launch has the first one's size (RGB).
static bool same_size(const PlaneSpecs& specs) {
  for (int k = 1; k < specs.n; ++k)
    if (specs.w[k] != specs.w[0] || specs.h[k] != specs.h[0]) return false;
  return true;
}

// Plain C entry point: returns the cudaError_t of the launch (0 = ok).
// spec is a host array of nplanes x (w, h, pbase) triples; plane k's
// samples start at column sum_{j<k} w_j * h_j of the (L, out_stride) out.
// five != 0 selects the 5-input context (qt holds five tables); gtab != 0
// the table-in-global-memory instance, where states_out must hold a copy
// of states0.
extern "C" int rc_decode_launch(RC_DEC_PARAMS, int bits, int five, int gtab,
                                void* stream) {
  PlaneSpecs specs;
  int wmax;
  if (!plane_specs(spec, nplanes, out_stride, specs, wmax))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define RC_DEC_CASE(B)                                                    \
  case B:                                                                 \
    return five ? (gtab ? launch<B, true, true, ALL_STAGES>(RC_DEC_ARGS)  \
                        : launch<B, true, false, ALL_STAGES>(RC_DEC_ARGS))\
                : (gtab ? launch<B, false, true, ALL_STAGES>(RC_DEC_ARGS) \
                        : launch<B, false, false, ALL_STAGES>(RC_DEC_ARGS));
  switch (bits) {
    RC_DEC_CASE(1) RC_DEC_CASE(2) RC_DEC_CASE(3) RC_DEC_CASE(4)
    RC_DEC_CASE(5) RC_DEC_CASE(6) RC_DEC_CASE(7) RC_DEC_CASE(8)
    RC_DEC_CASE(9) RC_DEC_CASE(10)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RC_DEC_CASE
}

// B1 (rc_decode_rgb_launch): the line-interleaved RGB decode at coded
// widths 9 (bgr0, bgra) and 10 (gbrp9), the same arguments and instances
// as rc_decode_launch.  Every plane has the slice's width and height, and
// plane k (G, B, R, A) names its state plane in its pbase: (k + 1) / 2 x
// the context count.
extern "C" int rc_decode_rgb_launch(RC_DEC_PARAMS, int bits, int five,
                                    int gtab, void* stream) {
  PlaneSpecs specs;
  int wmax;
  if (!plane_specs(spec, nplanes, out_stride, specs, wmax) ||
      !same_size(specs))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define RC_DEC_RGB_CASE(B)                                                 \
  case B:                                                                  \
    return five                                                            \
        ? (gtab ? launch<B, true, true, ALL_STAGES, true>(RC_DEC_ARGS)     \
                : launch<B, true, false, ALL_STAGES, true>(RC_DEC_ARGS))   \
        : (gtab ? launch<B, false, true, ALL_STAGES, true>(RC_DEC_ARGS)    \
                : launch<B, false, false, ALL_STAGES, true>(RC_DEC_ARGS));
  switch (bits) {
    RC_DEC_RGB_CASE(9) RC_DEC_RGB_CASE(10)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RC_DEC_RGB_CASE
}

// The stage probes: K2 at 8 bits with the stages of the bitmask ``stages``
// (STAGE_*) kept and the others stubbed, in either context and either
// table placement; timing only.  The variants: full (ALL_STAGES, the
// production instance itself), no_ctx, no_read, no_trans, no_write,
// no_refill and no_chain, each without one stage.
extern "C" int rc_decode_stages_launch(RC_DEC_PARAMS, int stages, int five,
                                       int gtab, void* stream) {
  PlaneSpecs specs;
  int wmax;
  if (!plane_specs(spec, nplanes, out_stride, specs, wmax))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define RC_STAGE_CASE(M)                                                  \
  case M:                                                                 \
    return five ? (gtab ? launch<8, true, true, M>(RC_DEC_ARGS)           \
                        : launch<8, true, false, M>(RC_DEC_ARGS))         \
                : (gtab ? launch<8, false, true, M>(RC_DEC_ARGS)          \
                        : launch<8, false, false, M>(RC_DEC_ARGS));
  switch (stages) {
    RC_STAGE_CASE(ALL_STAGES)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_CTX)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_READ)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_TRANS)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_WRITE)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_REFILL)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_CHAIN)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RC_STAGE_CASE
}

// B1's stage probes: the RGB instance the rgb8 path runs (bits 9, the
// 3-input context, the table in shared memory) with the stages of the
// bitmask ``stages`` kept and the others stubbed; timing only.  The
// variants: K2's, and no_line (the row pass and the row's output stores
// stubbed).  Other widths and instances have no probes.
extern "C" int rc_decode_rgb_stages_launch(RC_DEC_PARAMS, int stages,
                                           int five, int gtab,
                                           void* stream) {
  PlaneSpecs specs;
  int wmax;
  if (!plane_specs(spec, nplanes, out_stride, specs, wmax) ||
      !same_size(specs) || five || gtab)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define RC_STAGE_CASE(M) \
  case M:                \
    return launch<9, false, false, M, true>(RC_DEC_ARGS);
  switch (stages) {
    RC_STAGE_CASE(ALL_STAGES)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_CTX)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_READ)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_TRANS)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_WRITE)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_REFILL)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_CHAIN)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_LINE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RC_STAGE_CASE
}
