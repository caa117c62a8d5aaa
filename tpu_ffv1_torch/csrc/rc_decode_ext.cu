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
// What bounds it on the H100: as K2 (csrc/rc_decode.cu), the serial chain,
// one lane per warp and one warp per SM (L = 48 of the 132 SMs on the
// 1080p path), here up to 2 * BITS + 1 dependent decisions per pixel (33
// at 16 bits; 17.1 on the 16-bit path's content).  Each pixel's context,
// so its state row and its first decision, needs the value the pixel
// before decoded.  Bytes are few (~3 per pixel in, 4 out), so a pixel
// costs its decisions' latency plus the instructions its one warp runs
// in order between them.
//
// What the design does about it (K2's design, and the running rows):
//
// - Nothing between two decisions that can wait.  Every thread runs the
//   chain redundantly (every branch is warp-uniform) and holds the whole
//   state row in registers (two broadcast 16-byte loads).  The zero flag
//   and the exponent run over rows 1..9 are unrolled, left by one uniform
//   branch, their states byte extracts; the single-row mantissa states
//   (rows 22 + i, i = min(e, 9)-1..0) are gathered into packed registers
//   during that run, as in K2, and the sign's (row 11 + min(e, 10)) taken
//   at each step.  For e >= 9 the single-row mantissa bits are always i =
//   8..0 (rows 30..22), which the gathering leaves in place.
// - Row 10 (the exponent, j >= 9) off the chain: every continuing decision
//   on it has bit 1, so its k-th state is one^k(s10), one independent
//   lookup each in one_pow (one_tab applied k = 1..BITS-9 times, built in
//   shared memory at the start), started when the run reaches row 10.  The
//   final is zero[one^k(s10)] after a stop at the k-th decision, looked up
//   after the stop, or one^(BITS-9)(s10) when a damaged stream runs e to
//   BITS with no stop decision.
// - Row 31 (mantissa bits i >= 9, up to BITS - 9 decisions) depends on the
//   bits being decoded: both successors of its state come from one 16-bit
//   lookup started before the decision that uses it, so the next state is a
//   select on the bit.
// - No branch on the thread: in each decision at a single-touch position
//   (0, 1..9, 11..30) its owner takes the successor its bit picks by a
//   select; threads 10 and 31 take the running rows' finals; after the
//   pixel every thread stores its byte.  Both successors of a thread's
//   byte come from one 16-bit lookup right after the row read.
// - The refill byte: at a pixel's start thread t holds byte pos + t of the
//   slice, from a ring of the slice's bytes in shared memory (four
//   128-byte blocks, refilled one block ahead from global memory, so no
//   global load waits on the chain), and a renormalisation takes its byte
//   by shuffle from lane pos - p0.  The zero flag and the exponent run read
//   at most BITS + 1 bytes; a pixel can read 2 * BITS + 1 (35 at 17 bits),
//   so after the run, where the rest could pass the 32 bytes, the window
//   moves to pos (one uniform branch, rarely taken).  Reads at pos >= cap
//   give 0.
// - A row-parallel context: at each row's start the warp computes, 32
//   columns at a time, the part of every pixel's context that does not
//   depend on the row being decoded (LT - T, T - RT; FIVE: TT - T).  L's
//   terms (FIVE: and LL's) are looked up in the pixel before, for each
//   value it can take (pred, pred + a, pred - a, int16-wrapped at 16 bits;
//   the quant tables index & 0xFF, which the wrap does not change) before
//   the decision that picks one, together with the next pixel's row index
//   and context sign.
//
// Deferred adaptation is valid for every position except 10 and 31: the
// exponent rows 1..9, the mantissa rows 22..30 and the sign row 11..21 are
// each touched at most once per pixel, so the state a decision reads is the
// row's state before the pixel.  Rows 10 and 31 take several decisions per
// pixel, each with the state the one before left, hence their running
// states.  Thread t writes only byte t of a row but every thread reads
// every byte: one __syncwarp orders every thread's row read before the
// stores, another the stores before the next pixel's read.
//
// Time against the design before it (thread t reading only byte t, states
// by shuffle between decisions, a branch on the thread in each decision,
// rows 10/31 advanced by a dependent lookup after each of their decisions,
// the context on the pixel-to-pixel path, a 64-byte window reloaded from
// global memory on the chain), in one call on the 16-bit paths' warm-up
// inputs (tools/scan_variants.py, NVIDIA H100 80GB HBM3 at 700 W): 161.55
// against 310.62 ms (`rc_decode_ext`, N = 259,200 pixels per lane), 49.56
// against 89.63 (`rc_decode_ext_five_global`, N = 64,800).  Tried and
// dropped on the same inputs, each exact, ms against this design's in the
// same call (PERF.md): a 64-byte window, thread t holding bytes pos + t and
// pos + 32 + t, the renormalisation's source register selected before one
// shuffle (163.48 against 161.67) or after two (174.43); a two-byte refill
// queue in registers, the shuffle two bytes ahead and off the chain (163.83
// and 166.82 against 162.55); both outcomes of a decision renormalised
// before its bit picks one, a shorter dependency chain with more
// instructions (170.92-181.13 against 162.60); the single-row mantissa
// entered through a switch at its first bit, every state and position a
// constant, which compiles to an indirect branch (176.68 against 161.55);
// the exponent's and the mantissa's successors picked after the run from
// e and a instead of by owner selects in the decisions (164.45 against
// 161.34), and with it the window's bytes read counted instead of pos
// (167.06); row 10 by a dependent lookup after each of its decisions
// instead of one_pow (163.63 against 161.40; row 31's lookup placed after
// its decision was equal, 161.40: on that content 0.23% of the pixels
// reach row 10).  The decisions are bound by the instructions the warp
// runs, not by their chain's latency alone, and fewer instructions did
// not pay either.
//
// Table placement: the lane's state table (CC x 32 B, 23,360 B on the
// 16-bit path: 2 x 365 rows), the quant tables (three, FIVE: five), the
// byte ring (512 B), the transition pairs (512 B), one_pow (256 * (BITS
// - 9) B), two reconstructed rows (previous and current, w + 1 int32
// each) and the row's (T, context part) pairs live in shared memory
// (rc_decode.py: instance counts the same bytes).  Context model 1's
// table (2 x 5,063 rows from the 16-bit extradata, 324,032 B) does not
// fit a block: the GTAB instance keeps it in global memory instead,
// adapted in place in states_out, which the wrapper fills with states0;
// the chain code is the same, and the wrapper picks the instance from
// the table's size.  FIVE
// adds TT, the stale cur[x] of the 2-row ring (row y-2), and LL, the
// previous pixel's L (0 at x = 0), both int16-wrapped at 16 bits like
// every stored sample.  The context index is clamped so damaged streams
// stay inside the table.
//
// RGB (B1-ext: this kernel with RGB = true, reached through
// rc_decode_ext_rgb_launch at coded widths 11, 13 and 15 (gbrp10, 12, 14); it
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
// B1-ext's redesign began with its stage split (the LINE probe below) and
// a count of its pixel loop's SASS (PERF.md): every stub changed the
// decoded symbols and read a third fewer bytes or more, and the loop issues
// about 24 SASS instructions a decision (20 on row 10).  What was kept is
// in the loop it shares with K2-ext, as in B1 (csrc/rc_decode.cu): each
// decision's owner test is a compare with a constant (the running rows
// none, the single-row mantissa through jt = 21 + min(e, 9) - t).  In one
// call on the warm-up inputs (tools/scan_variants.py, NVIDIA H100 80GB
// HBM3 at 700 W), against the design before it: 33.70 against 34.03 ms
// (B1-ext, rgb14_540p), 160.57 against 162.19 (K2-ext, 16bit), 50.01
// against 50.07 (K2-ext-five, table in global memory).  Tried and dropped
// on the same inputs, each exact (PERF.md), as in B1: the next pixel's row
// read ahead for each value the pixel can take, with the refill window
// kept across pixels (38.15 against 33.97; K2-ext 184.81 against 162.25,
// K2-ext-five 65.66 against 50.06), and with the own byte from the
// registers and the adaptation picked after the pixel (39.10 against
// 33.79); the row's first word read ahead (36.26 against 34.00); the
// window kept across pixels (39.07 against 33.46 with the owner tests);
// the owner's decision picked after the pixel (33.93 against 33.72); the
// shuffle's source kept as the count of bytes the pixel read (33.86
// against 33.70).
//
// Stage probes (STAGES != ALL_STAGES, reached through
// rc_decode_ext_stages_launch, K2-ext at 16 bits, and
// rc_decode_ext_rgb_stages_launch, B1-ext at 15 bits, never by the codec):
// the same kernel with one stage stubbed, for timing only (their outputs
// are wrong on purpose), as K2's.  CTX: the context index from the decoded neighbours
// (stubbed: from the pixel's column; the context's sign stays live);
// READ: the row read (stubbed: the states constants); TRANS: the
// single-touch transition lookup (stubbed: the state stays); WRITE: the
// adaptation store; REFILL: the renormalisation byte and the ring
// (stubbed: a constant byte, no reload); CHAIN: the low/range arithmetic
// (stubbed: each bit a fixed function of its state, so the loops keep
// their shape); RUN: the running rows' lookups (stubbed: one_pow and row
// 31's successors give the state itself, and row 10's final is its last
// state); LINE (B1-ext's probes only): the row pass and the row's output
// stores (stubbed: every (T, context part) pair stays 0, nothing is
// written to out).  The production instances are ALL_STAGES.
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
  STAGE_RUN = 64,
  STAGE_LINE = 128,
  ALL_STAGES = 255
};

struct PlaneSpecs {
  int n;
  int w[MAX_PLANES], h[MAX_PLANES], pbase[MAX_PLANES], off[MAX_PLANES];
};

template <int BITS, bool FIVE, bool GTAB, bool RGB, int STAGES>
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
  constexpr int MASK_V = (1 << BITS) - 1;
  constexpr int NQ = FIVE ? 5 : 3;               // quant tables read
  // row-10 decisions (j = 9..BITS-1) and row-31 decisions (mantissa bits
  // i >= 9; BITS - 9 on a damaged stream, where e = BITS), at most
  constexpr int N_RUN = BITS - 9;
  static_assert(N_RUN >= 2 && 2 * BITS + 1 <= 64, "11..17 bits");
  constexpr bool CTX = (STAGES & STAGE_CTX) != 0;
  constexpr bool READ = (STAGES & STAGE_READ) != 0;
  constexpr bool TRANS = (STAGES & STAGE_TRANS) != 0;
  constexpr bool WRITE = (STAGES & STAGE_WRITE) != 0;
  constexpr bool REFILL = (STAGES & STAGE_REFILL) != 0;
  constexpr bool CHAIN = (STAGES & STAGE_CHAIN) != 0;
  constexpr bool RUN = (STAGES & STAGE_RUN) != 0;
  constexpr bool LINE = (STAGES & STAGE_LINE) != 0;
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  // CC x 32 state table: shared memory, or the lane's rows of states_out
  uint8_t* st = GTAB ? states_out + (size_t)lane * CC * 32 : smem;
  int32_t* qt_s = reinterpret_cast<int32_t*>(smem + (GTAB ? 0 : CC * 32));
  uint32_t* ring = reinterpret_cast<uint32_t*>(qt_s + NQ * 256);  // 512 B
  uint16_t* oz_s = reinterpret_cast<uint16_t*>(ring + 128);       // 512 B
  // one_pow[(k - 1) * 256 + s] = one_tab applied k times to s, k = 1..N_RUN
  uint8_t* one_pow = reinterpret_cast<uint8_t*>(oz_s + 256);
  int2* tc_s = reinterpret_cast<int2*>(one_pow + 256 * N_RUN);
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
  for (int i = t; i < 256; i += 32) {
    // both successors of a state in one lookup: one_tab low, zero_tab high
    oz_s[i] = (uint16_t)(one_tab[i] | (zero_tab[i] << 8));
    int s = i;
    for (int k = 1; k <= N_RUN; ++k) {
      s = __ldg(one_tab + s);
      one_pow[(k - 1) * 256 + i] = (uint8_t)s;
    }
  }

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

  // a sample folded to the coded width; at 16 bits stored int16-wrapped,
  // as the reference's int16_t sample rows hold it
  auto fold = [](int v) -> int {
    return BITS == 16 ? ((v + 0x8000) & 0xFFFF) - 0x8000 : v & MASK_V;
  };

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
        // the refill bytes: thread t holds byte p0 + t, from the ring
        int wb = 0;
        int p0 = pos;
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
        int val = fold(pred);             // a zero symbol
        place(tc_n.y, lterms(val), cin, csn);

        // one decision; the owner thread of its single-touch row position
        // (``own``; none for a running row) takes the successor its bit
        // picks
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
        // the running rows' final states, where the pixel touches them
        int fin10 = -1, fin31 = -1;
        if (!decide(sb(0), t == 0)) {     // nonzero symbol
          int e = 0;
          // P: the single-row mantissa states in coding order for the run
          // so far (byte j = row[21 + min(e, 9) - j]); ss: the sign's,
          // row[11 + min(e, 10)]
          uint32_t P[3] = {0, 0, 0};
          int ss = sb(11);
          // unary exponent + stop, rows 1..9
#pragma unroll
          for (int k = 1; k <= 9; ++k) {
            if (!decide(sb(k), t == k)) break;
            e = k;
            P[2] = __byte_perm(P[2], P[1], 0x2107);
            P[1] = __byte_perm(P[1], P[0], 0x2107);
            P[0] = __byte_perm(P[0], R[(21 + k) >> 2],
                               0x2104 + ((21 + k) & 3));
            ss = sb(11 + k);
          }
          if (e == 9) {
            // row 10 for j = 9..BITS-1: every continuing decision has bit
            // 1, so its k-th state is one^k(s10), one independent lookup
            // each; e reaches BITS only on damaged streams, with no stop
            // decision
            int p10[N_RUN + 1];
            p10[0] = sb(10);
#pragma unroll
            for (int k = 1; k <= N_RUN; ++k)
              p10[k] = RUN ? one_pow[(k - 1) * 256 + p10[0]] : p10[0];
            fin10 = p10[N_RUN];
#pragma unroll
            for (int k = 0; k < N_RUN; ++k) {
              if (!decide(p10[k], false)) {
                fin10 = RUN ? oz_s[p10[k]] >> 8 : p10[k];
                break;
              }
              e = 10 + k;
              ss = sb(21);
            }
          }
          // the zero flag and the exponent run read at most BITS + 1
          // bytes; if the rest (min(e, BITS - 1) + 1 decisions) could
          // pass the window, move it to pos (the ring holds at least 128
          // bytes from the pixel's start)
          if (REFILL && pos - p0 + min(e, BITS - 1) + 1 > 32) {
            p0 = pos;
            wb = reinterpret_cast<const uint8_t*>(ring)[(pos + t) & 511];
          }
          int a = 1;
          if (e >= 10) {
            // row 31 for mantissa bits i = e-1..9 (BITS-1..9 on a damaged
            // stream): its state follows the decoded bits; both
            // successors are looked up under the decision that uses s
            int s31 = sb(31);
#pragma unroll
            for (int r = 0; r < N_RUN; ++r) {
              if (r == e - 9) break;
              const int oz31 = RUN ? oz_s[s31] : s31 | (s31 << 8);
              const int bit = decide(s31, false);
              a = 2 * a + bit;
              s31 = bit ? oz31 & 0xFF : oz31 >> 8;
            }
            fin31 = s31;
          }
          // the single-row mantissa bits: i = min(e, 9)-1..0 (8..1 on a
          // damaged stream), rows 22 + i
          const int ep = min(e, 9);
          const int ns = e == BITS ? 8 : ep;
          const int jt = 21 + ep - t;      // thread t's decision j, if any
#pragma unroll
          for (int j = 0; j < 9; ++j) {
            if (j == ns) break;
            a = 2 * a + decide((int)__byte_perm(P[j >> 2], 0,
                                                 0x4440 | (j & 3)),
                               jt == j);
          }
          const int vp = fold(pred + a), vm = fold(pred - a);
          int cip, cim;
          bool csp, csm;
          place(tc_n.y, lterms(vp), cip, csp);
          place(tc_n.y, lterms(vm), cim, csm);
          const int sbit = decide(ss, t == 11 + min(e, 10));
          const bool neg = sbit != (int)csign;
          val = neg ? vm : vp;
          cin = neg ? cim : cip;
          csn = neg ? csm : csp;
        }
        nb = t == 10 && fin10 >= 0 ? fin10 : nb;
        nb = t == 31 && fin31 >= 0 ? fin31 : nb;
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
  // the state table (shared-memory instance), the quant tables, the byte
  // ring, oz, one_pow and per column the (T, context part) pair and the
  // rings' two rows (RGB: two per plane) (rc_decode.py: instance)
  const size_t smem = (GTAB ? 0 : (size_t)CC * 32) +
                      (FIVE ? 5 : 3) * 256 * 4 + 512 + 512 +
                      256 * (BITS - 9) +
                      (2 + 2 * (RGB ? specs.n : 1)) * (size_t)(wmax + 1) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rc_decode_ext_kernel<BITS, FIVE, GTAB, RGB, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rc_decode_ext_kernel<BITS, FIVE, GTAB, RGB, STAGES><<<L, 32, smem, stream>>>(
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
extern "C" int rc_decode_ext_launch(RC_DEC_PARAMS, int bits, int five,
                                    int gtab, void* stream) {
  PlaneSpecs specs;
  int wmax;
  if (!plane_specs(spec, nplanes, out_stride, specs, wmax))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define RC_DEC_EXT_CASE(B)                                                 \
  case B:                                                                  \
    return five ? (gtab ? launch<B, true, true, ALL_STAGES>(RC_DEC_ARGS)   \
                        : launch<B, true, false, ALL_STAGES>(RC_DEC_ARGS)) \
                : (gtab ? launch<B, false, true, ALL_STAGES>(RC_DEC_ARGS)  \
                        : launch<B, false, false, ALL_STAGES>(RC_DEC_ARGS));
  switch (bits) {
    RC_DEC_EXT_CASE(11) RC_DEC_EXT_CASE(12) RC_DEC_EXT_CASE(13)
    RC_DEC_EXT_CASE(14) RC_DEC_EXT_CASE(15) RC_DEC_EXT_CASE(16)
    RC_DEC_EXT_CASE(17)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RC_DEC_EXT_CASE
}

// B1-ext (rc_decode_ext_rgb_launch): the line-interleaved RGB decode at
// the coded widths of gbrp10, 12 and 14 (11, 13, 15), the same arguments
// and instances as rc_decode_ext_launch.  Every plane has the slice's
// width and height, and plane k (G, B, R) names its state plane in its
// pbase: (k + 1) / 2 x the context count.
extern "C" int rc_decode_ext_rgb_launch(RC_DEC_PARAMS, int bits, int five,
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
    RC_DEC_RGB_CASE(11) RC_DEC_RGB_CASE(13) RC_DEC_RGB_CASE(15)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RC_DEC_RGB_CASE
}

// The stage probes: K2-ext at 16 bits with the stages of the bitmask
// ``stages`` (STAGE_*) kept and the others stubbed, in either context and
// either table placement; timing only.  The variants: full (ALL_STAGES,
// the production instance itself), no_ctx, no_read, no_trans, no_write,
// no_refill, no_chain and no_run, each without one stage.
extern "C" int rc_decode_ext_stages_launch(RC_DEC_PARAMS, int stages,
                                           int five, int gtab,
                                           void* stream) {
  PlaneSpecs specs;
  int wmax;
  if (!plane_specs(spec, nplanes, out_stride, specs, wmax))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define RC_STAGE_CASE(M)                                                   \
  case M:                                                                  \
    return five ? (gtab ? launch<16, true, true, M>(RC_DEC_ARGS)           \
                        : launch<16, true, false, M>(RC_DEC_ARGS))         \
                : (gtab ? launch<16, false, true, M>(RC_DEC_ARGS)          \
                        : launch<16, false, false, M>(RC_DEC_ARGS));
  switch (stages) {
    RC_STAGE_CASE(ALL_STAGES)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_CTX)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_READ)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_TRANS)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_WRITE)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_REFILL)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_CHAIN)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_RUN)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RC_STAGE_CASE
}

// B1-ext's stage probes: the RGB instance the rgb14_540p path runs (bits
// 15, the 3-input context, the table in shared memory) with the stages of
// the bitmask ``stages`` kept and the others stubbed; timing only.  The
// variants: K2-ext's, and no_line (the row pass and the row's output
// stores stubbed).  Other widths and instances have no probes.
extern "C" int rc_decode_ext_rgb_stages_launch(RC_DEC_PARAMS, int stages,
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
    return launch<15, false, false, M, true>(RC_DEC_ARGS);
  switch (stages) {
    RC_STAGE_CASE(ALL_STAGES)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_CTX)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_READ)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_TRANS)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_WRITE)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_REFILL)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_CHAIN)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_RUN)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_LINE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RC_STAGE_CASE
}
