// Adaptive range-coder lane scan (FFV1 encode), coded widths <= 10 bits.
//
// Replaces the Pallas TPU kernel tpu_ffv1/tpu/rc_pallas.py `_kernel`
// (fast branch, compact=False, launched by `rc_encode_pallas_packed`).
// Same computation: L independent slice lanes; for each pixel read the
// lane's 32-byte context row at ctx, run the static decision chain
// (zero flag, exponent + stop, mantissa MSB->LSB, one collapsed sign
// slot), advance low/range with one-step renormalisation, emit
// provisional bytes, then adapt every touched state.
//
// What bounds it on the H100: the serial low/range chain, about 17
// dependent decisions per pixel at 8 bits, one pixel after another per
// lane.  Bytes are few (4 B of ctx + 4 B of residual + 1 B of flag in,
// 68 B of packed slots out per pixel).  At one lane per SM only L of the
// 132 SMs work (24 per stream in the batch).  With the table in global
// memory (below) each pixel's row read comes from L1/L2; the contexts are
// known in advance, so it is off the chain in principle, but here it
// waits behind the previous pixel's stores.
//
// Design: one warp per lane.  Where the lane's state table fits a block's
// shared memory (context model 0: CC x 32 B = 42,624 B on the 1080p main
// path), it is staged there at the start and written back at the end
// (GTAB = false).  Context model 1's table (2 x 7,563 rows, 484,032 B
// per lane) does not fit, so that instance (GTAB = true) adapts the rows
// in place in global memory, in states_out, which the wrapper fills with
// states0 (48 lanes = 23.2 MB, resident in the 50 MB L2): one coalesced
// 32-byte row read per pixel and the owners' byte stores after it.  Both
// instances run the same chain code; only where `st` points differs.
// Thread t reads and writes only byte t of a row, so a pixel that reads
// a row the previous pixel adapted sees the adapted byte (its own
// store).  The wrapper picks the instance from the table's size.
//
// Thread t owns position t of the
// context row: it reads its state byte once per pixel, the chain reads
// the 17 slot states from their owners with warp shuffles, and after the
// chain each thread adapts its own position in one parallel step.  That
// deferred, batched adaptation is valid because at bits <= 10 the
// positions touched within one pixel are pairwise distinct (sign row
// 11+e, exponent rows past e+1 inactive).  Every thread runs the chain
// redundantly, so no broadcast is needed; thread k keeps slot k's packed
// value and the warp writes a pixel's slots as one contiguous store.
// Inputs are read 32 pixels at a time, coalesced, one chunk ahead.
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
// pixel into (L, N, 8) storage (viewed as (N, 8, L)): 8 ints per pixel
// instead of S, and no per-pixel compaction pass after the scan.
//
// Stage probes (STAGES != ALL_STAGES, 8 bits only, reached through
// rc_encode_stages_launch and never by the codec) replace the TPU
// ablation probes scripts/probes/ablate_kernel.py:206 and ablate3.py:274:
// the same kernel with one stage stubbed, for timing only (their outputs
// are wrong on purpose).  READ: the row read (stubbed: a per-thread
// constant); TRANS: the transition lookup (stubbed: the state stays);
// WRITE: the adaptation store; CHAIN: the low/range chain and its
// emissions (stubbed: each slot stores its owner's state, so the reads
// stay live).  The production instances are ALL_STAGES and compile to
// the code they had before the parameter existed.
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

  int low = low0[lane];
  int rng = range0[lane];
  const int32_t* c_l = ctx + (size_t)lane * N;
  const int32_t* d_l = diff + (size_t)lane * N;
  const uint8_t* a_l = active + (size_t)lane * N;
  int32_t* out_l = packed + (size_t)lane * N * SOUT;

  int nc = 0, nd = 0, na = 0;
  if (t < N) { nc = c_l[t]; nd = d_l[t]; na = a_l[t]; }
  for (int base = 0; base < N; base += 32) {
    const int mc = nc, md = nd, ma = na;
    const int nxt = base + 32 + t;
    if (nxt < N) { nc = c_l[nxt]; nd = d_l[nxt]; na = a_l[nxt]; }
    const int cnt = min(32, N - base);
    for (int j = 0; j < cnt; ++j) {
      int c = __shfl_sync(FULL_MASK, mc, j);
      const int v = __shfl_sync(FULL_MASK, md, j);
      const bool ap = __shfl_sync(FULL_MASK, ma, j) != 0;
      c = min(max(c, 0), CC - 1);
      uint8_t* row = st + c * 32;
      int mys;
      if constexpr ((STAGES & STAGE_READ) != 0) {
        mys = row[t];
      } else {
        mys = 64 + 4 * t;
      }
      const int a = abs(v);
      const int e = 31 - __clz(max(a, 1));
      const bool nz = v != 0;

      // this thread's row position: activity and bit of its decision
      bool act_t;
      int bit_t;
      if (t == 0) {
        act_t = ap; bit_t = !nz;
      } else if (t <= 10) {
        act_t = ap && nz && (t - 1 <= e); bit_t = (t - 1) < e;
      } else if (t <= 21) {
        act_t = ap && nz && (t == 11 + e); bit_t = v < 0;
      } else {
        act_t = ap && nz && (t - 22 < e); bit_t = (a >> (t - 22)) & 1;
      }

      int my_pv = 0;
      if constexpr ((STAGES & STAGE_CHAIN) == 0) {
        my_pv = mys | (act_t ? 1 << 20 : 0);
      } else {
#pragma unroll
        for (int k = 0; k < S; ++k) {
          int p, b;
          bool act;
          if (k == 0) {
            p = 0; act = ap; b = !nz;
          } else if (k <= E_MAX + 1) {
            p = k; act = ap && nz && (k - 1 <= e); b = (k - 1) < e;
          } else if (k < S - 1) {
            const int m = E_MAX - 1 - (k - (E_MAX + 2));
            p = 22 + m; act = ap && nz && (m < e); b = (a >> m) & 1;
          } else {
            p = 11 + e; act = ap && nz; b = v < 0;
          }
          const int s = __shfl_sync(FULL_MASK, mys, p);
          const int r1 = (rng * s) >> 8;
          int nr = b ? r1 : rng - r1;
          int nl = low + (b ? rng - r1 : 0);
          const bool emit = act && nr < 0x100;
          if (t == k && emit)
            my_pv = (nl >> 8) | ((nl & 0xFF) ? (1 << 16) : 0) | (1 << 20);
          if (emit) {
            nl = (nl & 0xFF) << 8;
            nr <<= 8;
          }
          if (act) {
            low = nl;
            rng = nr;
          }
        }
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
        if constexpr ((STAGES & STAGE_TRANS) != 0) {
          if (act_t) row[t] = bit_t ? one_s[mys] : zero_s[mys];
        } else {
          if (act_t) row[t] = mys;
        }
      }
    }
  }
  __syncwarp();
  if (t == 0) {
    low_out[lane] = low;
    range_out[lane] = rng;
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
