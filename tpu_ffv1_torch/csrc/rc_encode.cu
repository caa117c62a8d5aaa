// Adaptive range-coder lane scan (FFV1 encode), coded widths <= 10 bits.
//
// Replaces the Pallas TPU kernel tpu_ffv1/tpu/rc_pallas.py `_kernel`
// (fast branch, compact=False, launched by `rc_encode_pallas_packed`).
// Same computation: L independent slice lanes; for each pixel read the
// lane's 32-byte context row at ctx, code the pixel's binary decisions
// (zero flag, exponent run with its stop bit, mantissa MSB->LSB, one
// collapsed sign slot), advance low/range with one-step renormalisation,
// emit provisional bytes, then adapt every touched state.
//
// What bounds it on the H100: the serial low/range chain, one pixel after
// another per lane, at one lane per warp and one warp per SM (L = 48 of
// the 132 SMs on the 1080p main path).  Bytes are few (4 B of ctx + 4 B
// of residual + 1 B of flag in, 4 B per slot out per pixel), so a pixel
// costs its decisions' latency plus everything else its one warp issues
// in order around them: input shuffles, the row read, the states'
// shuffles, branches, the adaptation and the stores.
//
// What the design does about it:
//
// - Only active decisions on the chain.  Every thread holds the same
//   residual, so each branch on activity is warp-uniform: a pixel codes
//   its zero flag (if active), then, if nonzero, exponent positions
//   1..e+1, mantissa bits e-1..0 and the sign: 2e + 3 decisions, not all
//   2 * bits + 1 slots.  The exponent run and the mantissa are prefixes
//   of fixed unrolled sequences, each left by one uniform branch (the
//   mantissa's states are shuffled in coding order, from lanes 21 + e -
//   i, so no jump table is needed).  The states of all decisions come by
//   shuffle from their owners before the first decision; between two
//   decisions there is no shuffle and no load.
// - No branch on the thread: each thread's activity and bit come from
//   two 32-bit masks over the row that every thread computes alike (a
//   branch on threadIdx diverges, and cost more than the decisions it
//   guarded).
// - Transition results off the chain: each thread owns position t of the
//   context row; right after its byte is known it looks up both
//   successors, and after the chain only the select on its bit and the
//   store remain.
// - With the table in global memory (below), the next row read ahead of
//   the adaptation store: thread t loads its byte of pixel j+1's row
//   before pixel j's store, and takes its own freshly adapted byte
//   instead when pixel j+1 has pixel j's context.  Thread t reads and
//   writes only byte t of a row, so that is the only alias; the chunk
//   boundary takes the next chunk's first context, and the read past the
//   last pixel is a harmless read of a valid row.  From shared memory
//   the read after the store is faster than the read ahead and its
//   select, so there the byte is read after the store.
//
// Deferred, batched adaptation is valid because at bits <= 10 the
// positions touched within one pixel are pairwise distinct (sign row
// 11+e, exponent rows past e+1 inactive).  Every thread runs the chain
// redundantly; thread k keeps slot k's packed value (a silent or skipped
// slot 0) and the warp writes a pixel's slots as one contiguous store.
// Inputs are read 32 pixels at a time, coalesced, one chunk ahead.
//
// Time against the design before it (every one of the 2 * bits + 1
// slots evaluated, each with its shuffle and select on the chain; the
// row read behind the previous pixel's store; branches on the thread),
// in one call on the 1080p main path's warm-up inputs (L = 48, N =
// 129,600), NVIDIA H100 80GB HBM3 at 700 W: 29.38 against 90.36 ms
// (table in shared memory), 34.08 against 96.74 (global), compact 35.96
// against 96.75 and 39.41 against 104.96.  Tried and dropped on the
// same inputs (PERF.md): the split as one multiply-add, (rng * m + k) >>
// 8 with (m, k) = (s, 0) or (256 - s, 255), with or without deferring
// the renormalisation into the next decision (exact, and 2.4-4.8 ms
// slower: more instructions per decision for one warp that issues in
// order); the read ahead from shared memory; a software pipeline that
// prepares pixel p+1 during pixel p; the row read by every thread as
// two 16-byte broadcast loads instead of the states' shuffles; a jump
// table into the mantissa.
//
// Table placement: where the lane's state table fits a block's shared
// memory (context model 0: CC x 32 B = 42,624 B on the 1080p main path),
// it is staged there at the start and written back at the end (GTAB =
// false).  Context model 1's table (2 x 7,563 rows, 484,032 B per lane)
// does not fit, so that instance (GTAB = true) adapts the rows in place
// in global memory, in states_out, which the wrapper fills with states0
// (48 lanes = 23.2 MB, resident in the 50 MB L2).  Both instances run the
// same chain; they differ in where `st` points and in the read ahead
// (above).  The wrapper picks the instance from the table's size.
//
// Output layout: packed int32 stored (L, N, S) (the wrapper returns it
// viewed as the Pallas contract's (N, S, L)).  An emitting slot holds
// (low >> 8) | (low & 0xFF ? 1 << 16 : 0) | 1 << 20, a silent slot 0.
//
// K1-compact (COMPACT = true) replaces the same Pallas kernel's
// compact=True branch (rc_pallas.py:419-445, rc_encode_pallas_compact):
// the chain, low, range and states are K1's; only the per-pixel store
// differs.  A ballot over the slot owners gives the emit mask and its
// popcount the pixel's count; thread r < 4 fetches the r-th emitting
// slot's value (bits 0..16) by shuffle from its owner, and the warp
// stores one 32-byte row [slot0..slot3, count, count > 4, 0, 0] per
// pixel into (L, N, 8) storage (viewed as (N, 8, L)).
//
// Stage probes (STAGES != ALL_STAGES, 8 bits only, reached through
// rc_encode_stages_launch and never by the codec) replace the TPU
// ablation probes scripts/probes/ablate_kernel.py:206 and ablate3.py:274:
// the same kernel with one stage stubbed, for timing only (their outputs
// are wrong on purpose).  READ: the row read (stubbed: a per-thread
// constant); TRANS: the transition lookup (stubbed: the state stays);
// WRITE: the adaptation store; CHAIN: the low/range chain and its
// emissions (stubbed: each slot stores its owner's state, so the reads
// stay live).  The production instances are ALL_STAGES.
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

enum : int {
  STAGE_READ = 1,
  STAGE_TRANS = 2,
  STAGE_WRITE = 4,
  STAGE_CHAIN = 8,
  ALL_STAGES = 15
};

// The coder state between decisions, renormalised (rng, low); cap_* keep
// the split of the decision in this thread's slot, before its
// renormalisation.
struct Coder {
  int rng, low;
  int cap_r, cap_l;

  __device__ __forceinline__ void decide(int s, bool b, int slot, int t) {
    const int r1 = (rng * s) >> 8;
    int nr = b ? r1 : rng - r1;
    int nl = low + (b ? rng - r1 : 0);
    if (t == slot) {
      cap_r = nr;
      cap_l = nl;
    }
    if (nr < 0x100) {
      nl = (nl & 0xFF) << 8;
      nr <<= 8;
    }
    rng = nr;
    low = nl;
  }
};

template <int BITS, bool GTAB, bool COMPACT, int STAGES>
__global__ void __launch_bounds__(32) rc_encode_kernel(
    const int32_t* __restrict__ ctx, const int32_t* __restrict__ diff,
    const uint8_t* __restrict__ active, const uint8_t* __restrict__ states0,
    const uint8_t* __restrict__ one_tab, const uint8_t* __restrict__ zero_tab,
    const int32_t* __restrict__ low0, const int32_t* __restrict__ range0,
    int32_t* __restrict__ packed, int32_t* __restrict__ low_out,
    int32_t* __restrict__ range_out, uint8_t* __restrict__ states_out,
    int N, int CC) {
  constexpr int E_MAX = BITS - 1;
  constexpr int S = 2 * BITS + 1;   // zero, E_MAX+1 exp, E_MAX man, sign
  constexpr int SOUT = COMPACT ? 8 : S;   // ints stored per pixel
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  // CC x 32 state table: shared memory, or the lane's rows of states_out
  uint8_t* st = GTAB ? states_out + (size_t)lane * CC * 32 : smem;
  uint8_t* one_s = smem + (GTAB ? 0 : CC * 32);
  uint8_t* zero_s = one_s + 256;

  if (!GTAB) {
    const uint4* src = reinterpret_cast<const uint4*>(
        states0 + (size_t)lane * CC * 32);
    for (int i = t; i < CC * 2; i += 32)
      reinterpret_cast<uint4*>(st)[i] = src[i];
  }
  for (int i = t; i < 256; i += 32) {
    one_s[i] = one_tab[i];
    zero_s[i] = zero_tab[i];
  }
  __syncwarp();

  Coder cd{range0[lane], low0[lane], 0, 0};
  const int32_t* c_l = ctx + (size_t)lane * N;
  const int32_t* d_l = diff + (size_t)lane * N;
  const uint8_t* a_l = active + (size_t)lane * N;
  int32_t* out_l = packed + (size_t)lane * N * SOUT;

  // this thread's pixel of the next chunk: its clamped context, and its
  // residual with the active flag in bit 0
  int nc = 0, nva = 0;
  auto fetch = [&](int i) {
    if (i < N) {
      nc = min(max(c_l[i], 0), CC - 1);
      nva = (d_l[i] << 1) | (a_l[i] != 0);
    }
  };
  fetch(t);
  int c = __shfl_sync(FULL_MASK, nc, 0);
  uint8_t* row = st + c * 32;
  // this thread's byte of a row (a constant in the stage probe no_read)
  auto read = [&](const uint8_t* r) {
    if constexpr ((STAGES & STAGE_READ) != 0) {
      return (int)r[t];
    } else {
      return 64 + 4 * t;
    }
  };
  int mys = read(row);
  for (int base = 0; base < N; base += 32) {
    const int mc = nc, mva = nva;
    fetch(base + 32 + t);
    const int cnt = min(32, N - base);
    for (int j = 0; j < cnt; ++j) {
      const int va = __shfl_sync(FULL_MASK, mva, j);
      // the next pixel's context (the next chunk's first at j = 31; past
      // the last pixel some valid row, read and never used)
      const int cn = __shfl_sync(FULL_MASK, j < 31 ? mc : nc, (j + 1) & 31);
      uint8_t* row_n = st + cn * 32;
      // global table: the next pixel's byte read ahead, before this
      // pixel's store
      const int mys_n = GTAB ? read(row_n) : 0;

      const int v = va >> 1;
      const bool ap = (va & 1) != 0;
      const int a = abs(v);
      const int e = 31 - __clz(max(a, 1));
      const bool nz = v != 0;

      // both successors of this thread's byte, in flight during the chain
      int up = 0, dn = 0;
      if constexpr ((STAGES & STAGE_TRANS) != 0) {
        up = one_s[mys];
        dn = zero_s[mys];
      }

      int my_pv = 0;
      if constexpr ((STAGES & STAGE_CHAIN) != 0) {
        cd.cap_r = 0x100;             // no decision in this slot yet
        const int s0 = __shfl_sync(FULL_MASK, mys, 0);
        if (ap) {
          if (!nz) {
            cd.decide(s0, true, 0, t);
          } else {
            // every state of the pixel before its first decision
            // sm[i]: the state of mantissa bit e - 1 - i (i < e)
            int sx[E_MAX + 2], sm[E_MAX > 0 ? E_MAX : 1];
#pragma unroll
            for (int k = 1; k <= E_MAX + 1; ++k)
              sx[k] = __shfl_sync(FULL_MASK, mys, k);
#pragma unroll
            for (int i = 0; i < E_MAX; ++i)
              sm[i] = __shfl_sync(FULL_MASK, mys, 21 + e - i);
            const int ssg = __shfl_sync(FULL_MASK, mys, 11 + e);
            cd.decide(s0, false, 0, t);
            // exponent run: positions 1..e with bit 1, e+1 with bit 0
#pragma unroll
            for (int k = 1; k <= E_MAX + 1; ++k) {
              const bool b = k - 1 < e;
              cd.decide(sx[k], b, k, t);
              if (!b) break;
            }
            // mantissa bits e-1..0 (bit m in slot 2 * E_MAX + 1 - m)
#pragma unroll
            for (int i = 0; i < E_MAX; ++i) {
              if (i == e) break;
              const int m = e - 1 - i;
              cd.decide(sm[i], (a >> m) & 1, 2 * E_MAX + 1 - m, t);
            }
            cd.decide(ssg, v < 0, S - 1, t);
          }
        }
        if (t < S && cd.cap_r < 0x100)
          my_pv = (cd.cap_l >> 8) | ((cd.cap_l & 0xFF) ? (1 << 16) : 0) |
                  (1 << 20);
      }
      // the row positions the pixel codes and their bits, as masks over
      // the row (zero flag 0, exponent 1..e+1, sign 11+e, mantissa
      // 22..21+e), the same in every thread; this thread's from them
      const unsigned em_e = (2u << e) - 1;      // bits 0..e
      const unsigned act_m =
          ap ? (nz ? 1u | (em_e << 1) | (1u << (11 + e)) |
                         ((em_e >> 1) << 22)
                   : 1u)
             : 0u;
      const unsigned bit_m = (nz ? 0u : 1u) | ((em_e >> 1) << 1) |
                             ((v < 0 ? 1u : 0u) << (11 + e)) |
                             (((unsigned)a & (em_e >> 1)) << 22);
      const bool act_t = (act_m >> t) & 1;
      const int bit_t = (bit_m >> t) & 1;
      if constexpr ((STAGES & STAGE_CHAIN) == 0)
        my_pv = mys | (act_t ? 1 << 20 : 0);
      // its adapted byte
      int new_t = mys;
      if constexpr ((STAGES & STAGE_TRANS) != 0) {
        if (act_t) new_t = bit_t ? up : dn;
      }
      if constexpr (COMPACT) {
        // emit mask over the slot owners; thread r < 4 takes the r-th
        // emitting slot's value from its owner (0 past the count)
        const unsigned em =
            __ballot_sync(FULL_MASK, t < S && ((my_pv >> 20) & 1));
        const int cnt = __popc(em);
        unsigned rest = em;   // em without its lowest min(t, 3) set bits
        if (t >= 1) rest &= rest - 1;
        if (t >= 2) rest &= rest - 1;
        if (t >= 3) rest &= rest - 1;
        const int pv = __shfl_sync(FULL_MASK, my_pv, (__ffs(rest) - 1) & 31);
        const int cm = t < 4 ? (rest ? pv & 0x1FFFF : 0)
                             : t == 4 ? cnt : t == 5 ? (cnt > 4) : 0;
        if (t < 8) out_l[(size_t)(base + j) * 8 + t] = cm;
      } else {
        if (t < S) out_l[(size_t)(base + j) * S + t] = my_pv;
      }
      if constexpr ((STAGES & STAGE_WRITE) != 0) {
        if (act_t) row[t] = new_t;
      }
      // the next pixel's byte: read after the store from shared memory;
      // from global memory read ahead, or this pixel's adapted byte where
      // the next pixel shares its row
      if constexpr (GTAB) {
        mys = cn == c ? new_t : mys_n;
      } else {
        mys = read(row_n);
      }
      c = cn;
      row = row_n;
    }
  }
  __syncwarp();
  if (t == 0) {
    low_out[lane] = cd.low;
    range_out[lane] = cd.rng;
  }
  if (!GTAB) {
    uint4* dst = reinterpret_cast<uint4*>(states_out + (size_t)lane * CC * 32);
    for (int i = t; i < CC * 2; i += 32)
      dst[i] = reinterpret_cast<const uint4*>(st)[i];
  }
}

template <int BITS, bool GTAB, bool COMPACT, int STAGES>
static int launch(const void* ctx, const void* diff, const void* active,
                  const void* states0, const void* one_tab,
                  const void* zero_tab, const void* low0,
                  const void* range0, void* packed, void* low_out,
                  void* range_out, void* states_out, int L, int N, int CC,
                  cudaStream_t stream) {
  const size_t smem = (GTAB ? 0 : (size_t)CC * 32) + 512;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rc_encode_kernel<BITS, GTAB, COMPACT, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rc_encode_kernel<BITS, GTAB, COMPACT, STAGES><<<L, 32, smem, stream>>>(
      (const int32_t*)ctx, (const int32_t*)diff, (const uint8_t*)active,
      (const uint8_t*)states0, (const uint8_t*)one_tab,
      (const uint8_t*)zero_tab, (const int32_t*)low0,
      (const int32_t*)range0, (int32_t*)packed, (int32_t*)low_out,
      (int32_t*)range_out, (uint8_t*)states_out, N, CC);
  return (int)cudaGetLastError();
}

#define RC_ENC_ARGS                                                        \
  ctx, diff, active, states0, one_tab, zero_tab, low0, range0, packed,     \
      low_out, range_out, states_out, L, N, CC
#define RC_ENC_PARAMS                                                      \
  const void *ctx, const void *diff, const void *active,                   \
      const void *states0, const void *one_tab, const void *zero_tab,      \
      const void *low0, const void *range0, void *packed, void *low_out,   \
      void *range_out, void *states_out, int L, int N, int CC

template <bool COMPACT>
static int launch_bits(RC_ENC_PARAMS, int bits, int gtab, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define RC_ENC_CASE(B)                                                     \
  case B:                                                                  \
    return gtab ? launch<B, true, COMPACT, ALL_STAGES>(RC_ENC_ARGS, s)     \
                : launch<B, false, COMPACT, ALL_STAGES>(RC_ENC_ARGS, s);
  switch (bits) {
    RC_ENC_CASE(1) RC_ENC_CASE(2) RC_ENC_CASE(3) RC_ENC_CASE(4)
    RC_ENC_CASE(5) RC_ENC_CASE(6) RC_ENC_CASE(7) RC_ENC_CASE(8)
    RC_ENC_CASE(9) RC_ENC_CASE(10)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RC_ENC_CASE
}

// Plain C entry points: each returns the cudaError_t of the launch (0 =
// ok).  gtab != 0 selects the table-in-global-memory instance; states_out
// must then hold a copy of states0.  rc_encode_launch writes the raw
// (L, N, 2 * bits + 1) slots (K1), rc_encode_compact_launch the (L, N, 8)
// compact rows (K1-compact).
extern "C" int rc_encode_launch(RC_ENC_PARAMS, int bits, int gtab,
                                void* stream) {
  return launch_bits<false>(RC_ENC_ARGS, bits, gtab, stream);
}

extern "C" int rc_encode_compact_launch(RC_ENC_PARAMS, int bits, int gtab,
                                        void* stream) {
  return launch_bits<true>(RC_ENC_ARGS, bits, gtab, stream);
}

// The stage probes: K1 at 8 bits with the stages of the bitmask
// ``stages`` (STAGE_*) kept and the others stubbed; timing only.  The
// six variants of the TPU probes: full (ALL_STAGES, the production
// instance itself), no_read, no_trans, no_write, no_chain and loops_only
// (READ | WRITE).
extern "C" int rc_encode_stages_launch(RC_ENC_PARAMS, int stages, int gtab,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define RC_STAGE_CASE(M)                                                   \
  case M:                                                                  \
    return gtab ? launch<8, true, false, M>(RC_ENC_ARGS, s)                \
                : launch<8, false, false, M>(RC_ENC_ARGS, s);
  switch (stages) {
    RC_STAGE_CASE(ALL_STAGES)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_READ)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_TRANS)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_WRITE)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_CHAIN)
    RC_STAGE_CASE(STAGE_READ | STAGE_WRITE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RC_STAGE_CASE
}
