// Adaptive range-coder lane scan (FFV1 encode), extended schedule for
// coded widths 11..17 bits (K1-ext).
//
// Replaces the Pallas TPU kernel tpu_ffv1/tpu/rc_pallas.py `_kernel`,
// extended-schedule branch (rc_pallas.py:317-389, slot order
// rc_scan_fast.ext_slots, launched by `rc_encode_pallas_packed` at
// bits > 10).  Same computation as rc_scan_lanes.rc_encode_scan_lanes_ext:
// L independent slice lanes; for each pixel read the lane's 32-byte
// context row at ctx and code the pixel's binary decisions in the slot
// order
//
//   zero | exp j = 0..E_MAX (row 1 + min(j, 9)) | man31 r = 0..E_MAX-10
//   (row 31, bit e-1-r) | man i = 8..0 (row 22 + i) | sign (row
//   11 + min(e, 10))
//
// advancing low/range with one-step renormalisation and emitting
// provisional bytes.  put_symbol's row caps (ffv1enc.c:185-231) make rows
// 10 and 31 carry several decisions per pixel at these widths, each with
// the state the previous one left (the running rows); every other
// position is touched at most once per pixel.
//
// What bounds it on the H100: as K1 (csrc/rc_encode.cu), the serial
// low/range chain, one pixel after another per lane at one warp per lane
// (L = 48 of the 132 SMs on the 1080p path), plus whatever else the warp
// issues in order around the decisions.  Bytes are few (9 B in and 4 * S
// B out per pixel, 141 B at 16 bits).
//
// What the design does about it (K1's design, and the running rows):
//
// - Only active decisions on the chain.  Every thread holds the same
//   residual, so each branch on it is warp-uniform: a pixel codes its
//   zero flag, then, if nonzero, the exponent run j = 0..e (rows 1..9,
//   then row 10 for j >= 9), the mantissa bits e-1..0 (row 31 for bits
//   >= 9, rows 22 + i below) and the sign: 2e + 3 decisions, not all
//   2 * bits + 1 slots.  Each run is a prefix of a fixed unrolled
//   sequence, left by one uniform branch.
// - Every state before the first decision; between two decisions no
//   shuffle and no load.  Rows 1..9, 22..30 and the sign row come by
//   shuffle from their owners (the mantissa's in coding order, from
//   lanes 21 + min(e, 9) - i).  Row 10's run visits one^k(s10), k =
//   0..e-9: one independent lookup each in one_pow[k] (one_tab applied k
//   times, built in shared memory at the kernel's start).  Row 31's run
//   follows the mantissa bits e-1..9, all known before the zero flag:
//   its states are looked up as a sequence there, in the shadow of the
//   at least 11 decisions before the first on row 31.
// - No branch on the thread: each thread's activity and bit come from
//   masks over the 30 single-touch positions that every thread computes
//   alike; threads 10 and 31 store the running rows' final values
//   (zero[one_pow[e-9][s10]], and row 31's state after its last bit),
//   computed off the chain.
// - Transition results off the chain: each owner looks up both
//   successors of its byte as soon as the byte is known; after the
//   chain only the select on its bit and the store remain.
// - Slot captures at static indices: thread t keeps the split of slot t
//   and of slot t + 32 (S = 23..35), in the chain's registers; only the
//   mantissa's single-row slots have an index that depends on e.
// - With the table in global memory, the next row read ahead of the
//   adaptation store, the adapted byte forwarded when the next pixel has
//   the same context (as K1); the residual and the active flag arrive
//   packed in one word.
//
// Time against the design before it (every one of the 2 * bits + 1
// slots evaluated, each with its shuffle and selects; rows 10/31
// advanced by a dependent lookup after each of their decisions; the
// activity and the store by branches on the thread), in one call on the
// 16-bit path's warm-up inputs (L = 48, N = 259,200), NVIDIA H100 80GB
// HBM3 at 700 W (tools/scan_variants.py): 139.72 against 346.44 ms in
// shared memory, 36.23 against 93.91 in global memory (960x540, N =
// 64,800); the chain bound is 106.15 ms.  Tried and dropped on the same
// inputs (PERF.md): the adaptation store and the next row's read placed
// before the first decision (145.20 and 35.47 ms: the transition and
// running-row lookups then stand in front of the chain), or after the
// exponent run (145.52 and 38.16); in another call against 139.82 and
// 36.32, the zero flag's state read by every thread as a broadcast
// byte after a __syncwarp instead of shuffled (140.52 and 36.30), the
// masks computed before the chain (142.80 and 35.93), both (141.53 and
// 36.00).  The running rows' lookups cost 1.8 ms in the stage split, so
// no multi-bit step table for row 31.
//
// Table placement: as K1's.  Where the lane's state table fits a block's
// shared memory (context model 0: CC x 32 B = 42,624 B on the 1080p
// path) it is staged there at the start and written back at the end
// (GTAB = false); context model 1's (2 x 7,563 rows, 484,032 B) does not
// fit, so that instance (GTAB = true) adapts the rows in place in
// states_out, which the wrapper fills with states0.  Both instances run
// the same chain.  Shared memory also holds one_tab, zero_tab and
// one_pow (256 * (BITS - 10) B).  Output offsets are size_t: L * N * S *
// 4 bytes passes 2^31 on the 1080p 16-bit path (1.64 GB).
//
// Output layout: packed int32 stored (L, N, S) (the wrapper returns it
// viewed as the Pallas contract's (N, S, L)).  An emitting slot holds
// (low >> 8) | (low & 0xFF ? 1 << 16 : 0) | 1 << 20, a silent or
// uncoded slot 0.
//
// Stage probes (STAGES != ALL_STAGES, 16 bits only, reached through
// rc_encode_ext_stages_launch and never by the codec): the same kernel
// with one stage stubbed, for timing only (their outputs are wrong on
// purpose), as K1's.  READ: the row read (stubbed: a per-thread
// constant); TRANS: the single-touch transitions (stubbed: the state
// stays); WRITE: the adaptation store; CHAIN: the low/range chain, its
// emissions and the states' shuffles (stubbed: each slot owner stores its
// byte); RUN: the running rows' lookups (stubbed: s10 and s31 stay).
// The production instances are ALL_STAGES.
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

enum : int {
  STAGE_READ = 1,
  STAGE_TRANS = 2,
  STAGE_WRITE = 4,
  STAGE_CHAIN = 8,
  STAGE_RUN = 16,
  ALL_STAGES = 31
};

// The coder state between decisions, renormalised (rng, low); cap_*0 and
// cap_*1 keep the split of the decisions in slots t and t + 32, before
// their renormalisation.
struct Coder {
  int rng, low;
  int cap_r0, cap_l0, cap_r1, cap_l1;

  // HI: the largest slot index the call can pass
  template <int HI>
  __device__ __forceinline__ void decide(int s, bool b, int slot, int t) {
    const int r1 = (rng * s) >> 8;
    int nr = b ? r1 : rng - r1;
    int nl = low + (b ? rng - r1 : 0);
    if (HI < 32 || slot < 32) {
      if (t == slot) {
        cap_r0 = nr;
        cap_l0 = nl;
      }
    } else if (t == slot - 32) {
      cap_r1 = nr;
      cap_l1 = nl;
    }
    if (nr < 0x100) {
      nl = (nl & 0xFF) << 8;
      nr <<= 8;
    }
    rng = nr;
    low = nl;
  }
};

__device__ __forceinline__ int packed_value(int cap_r, int cap_l) {
  return cap_r < 0x100
             ? (cap_l >> 8) | ((cap_l & 0xFF) ? (1 << 16) : 0) | (1 << 20)
             : 0;
}

template <int BITS, bool GTAB, int STAGES>
__global__ void __launch_bounds__(32) rc_encode_ext_kernel(
    const int32_t* __restrict__ ctx, const int32_t* __restrict__ diff,
    const uint8_t* __restrict__ active, const uint8_t* __restrict__ states0,
    const uint8_t* __restrict__ one_tab, const uint8_t* __restrict__ zero_tab,
    const int32_t* __restrict__ low0, const int32_t* __restrict__ range0,
    int32_t* __restrict__ packed, int32_t* __restrict__ low_out,
    int32_t* __restrict__ range_out, uint8_t* __restrict__ states_out,
    int N, int CC) {
  constexpr int E_MAX = BITS - 1;
  constexpr int N_R10 = E_MAX - 8;          // row-10 decisions, j = 9..E_MAX
  constexpr int N_M31 = E_MAX - 9;          // row-31 decisions, r = 0..
  constexpr int S = 2 * BITS + 1;
  static_assert(N_M31 >= 1 && S <= 64, "11..17 bits");
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  // CC x 32 state table: shared memory, or the lane's rows of states_out
  uint8_t* st = GTAB ? states_out + (size_t)lane * CC * 32 : smem;
  uint8_t* one_s = smem + (GTAB ? 0 : CC * 32);
  uint8_t* zero_s = one_s + 256;
  // one_pow[k - 1][s] = one_tab applied k times to s, k = 1..N_R10-1
  uint8_t* one_pow = zero_s + 256;

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
  for (int i = t; i < 256; i += 32) {
    int s = i;
    for (int k = 1; k < N_R10; ++k) {
      s = one_s[s];
      one_pow[(k - 1) * 256 + i] = s;
    }
  }
  __syncwarp();

  Coder cd{range0[lane], low0[lane], 0, 0, 0, 0};
  const int32_t* c_l = ctx + (size_t)lane * N;
  const int32_t* d_l = diff + (size_t)lane * N;
  const uint8_t* a_l = active + (size_t)lane * N;
  int32_t* out_l = packed + (size_t)lane * N * S;

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
      const bool apnz = ap && nz;
      const int ep = min(e, 9);               // mantissa bits on rows 22..

      // both successors of this thread's byte, in flight during the chain
      int up = 0, dn = 0;
      if constexpr ((STAGES & STAGE_TRANS) != 0) {
        up = one_s[mys];
        dn = zero_s[mys];
      }

      // the running rows' final states (where the pixel touches them)
      int fin10 = 0, fin31 = 0;
      int my_pv0 = 0, my_pv1 = 0;
      if (apnz) {
        // p10[k]: row 10's state at its k-th decision; p31[r]: row 31's
        // at decision r (mantissa bit e-1-r)
        int p10[N_R10], p31[N_M31];
        if (e >= 9) {
          const int s10 = __shfl_sync(FULL_MASK, mys, 10);
          p10[0] = s10;
          if constexpr ((STAGES & STAGE_RUN) != 0) {
#pragma unroll
            for (int k = 1; k < N_R10; ++k)
              p10[k] = one_pow[(k - 1) * 256 + s10];
            const int last = e == 9 ? s10 : one_pow[(e - 10) * 256 + s10];
            fin10 = zero_s[last];
          } else {
#pragma unroll
            for (int k = 1; k < N_R10; ++k) p10[k] = s10;
            fin10 = s10;
          }
          if (e >= 10) {
            int s31 = __shfl_sync(FULL_MASK, mys, 31);
#pragma unroll
            for (int r = 0; r < N_M31; ++r) {
              p31[r] = s31;
              if constexpr ((STAGES & STAGE_RUN) != 0) {
                if (r <= e - 10)
                  s31 = (a >> (e - 1 - r)) & 1 ? one_s[s31] : zero_s[s31];
              }
            }
            fin31 = s31;
          }
        }
        if constexpr ((STAGES & STAGE_CHAIN) != 0) {
          // every single-touch state of the pixel before its first
          // decision; sm[i]: the state of mantissa bit ep - 1 - i
          int sx[9], sm[9];
#pragma unroll
          for (int k = 0; k < 9; ++k)
            sx[k] = __shfl_sync(FULL_MASK, mys, 1 + k);
#pragma unroll
          for (int i = 0; i < 9; ++i)
            sm[i] = __shfl_sync(FULL_MASK, mys, 21 + ep - i);
          const int ssg = __shfl_sync(FULL_MASK, mys, 11 + min(e, 10));
          const int s0 = __shfl_sync(FULL_MASK, mys, 0);
          cd.cap_r0 = cd.cap_r1 = 0x100;    // no decision in a slot yet
          cd.decide<0>(s0, false, 0, t);
          // exponent run: j = 0..8 on rows 1..9, bit j < e
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            const bool b = k < e;
            cd.decide<9>(sx[k], b, 1 + k, t);
            if (!b) break;
          }
          if (e >= 9) {
            // j = 9..e on row 10
#pragma unroll
            for (int k = 0; k < N_R10; ++k) {
              const bool b = 9 + k < e;
              cd.decide<1 + E_MAX>(p10[k], b, 10 + k, t);
              if (!b) break;
            }
            if (e >= 10) {
              // mantissa bits e-1..9 on row 31 (slot 1 + BITS + r)
#pragma unroll
              for (int r = 0; r < N_M31; ++r) {
                if (r > e - 10) break;
                cd.decide<BITS + N_M31>(p31[r], (a >> (e - 1 - r)) & 1,
                                        1 + BITS + r, t);
              }
            }
          }
          // mantissa bits ep-1..0 on rows 22.. (bit m in slot
          // 2 * BITS - 1 - m)
#pragma unroll
          for (int i = 0; i < 9; ++i) {
            if (i == ep) break;
            const int m = ep - 1 - i;
            cd.decide<2 * BITS - 1>(sm[i], (a >> m) & 1, 2 * BITS - 1 - m, t);
          }
          cd.decide<2 * BITS>(ssg, v < 0, 2 * BITS, t);
          my_pv0 = packed_value(cd.cap_r0, cd.cap_l0);
          my_pv1 = packed_value(cd.cap_r1, cd.cap_l1);
        }
      } else if (ap) {
        if constexpr ((STAGES & STAGE_CHAIN) != 0) {
          const int s0 = __shfl_sync(FULL_MASK, mys, 0);
          cd.cap_r0 = 0x100;
          cd.decide<0>(s0, true, 0, t);
          my_pv0 = packed_value(cd.cap_r0, cd.cap_l0);
        }
      }
      // the single-touch positions the pixel codes and their bits, as
      // masks over the row (zero flag 0, exponent 1..min(e, 8) + 1, sign
      // 11 + min(e, 10), mantissa 22..21 + ep), and the running rows it
      // touches (10, 31); the same in every thread, this thread's bits
      // from them
      const unsigned mm = (1u << ep) - 1;
      const int sp = 11 + min(e, 10);
      const unsigned act_m =
          ap ? (nz ? 1u | (((2u << min(e, 8)) - 1) << 1) | (1u << sp) |
                         (mm << 22)
                   : 1u)
             : 0u;
      const unsigned bit_m = (nz ? 0u : 1u) | (mm << 1) |
                             ((v < 0 ? 1u : 0u) << sp) |
                             (((unsigned)a & mm) << 22);
      const unsigned run_m =
          apnz && e >= 9 ? (1u << 10) | (e >= 10 ? 1u << 31 : 0u) : 0u;
      const bool act_t = (act_m >> t) & 1;
      const int bit_t = (bit_m >> t) & 1;
      const bool run_t = (run_m >> t) & 1;
      if constexpr ((STAGES & STAGE_CHAIN) == 0) {
        my_pv0 = mys | (act_t ? 1 << 20 : 0);
        my_pv1 = mys;
      }
      // its adapted byte
      int new_t = mys;
      if constexpr ((STAGES & STAGE_TRANS) != 0) {
        if (act_t) new_t = bit_t ? up : dn;
      }
      if (run_t) new_t = t == 10 ? fin10 : fin31;
      int32_t* px = out_l + (size_t)(base + j) * S;
      if (t < S) px[t] = my_pv0;
      if (t + 32 < S) px[t + 32] = my_pv1;
      if constexpr ((STAGES & STAGE_WRITE) != 0) {
        if (act_t || run_t) row[t] = new_t;
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

template <int BITS, bool GTAB, int STAGES>
static int launch(const void* ctx, const void* diff, const void* active,
                  const void* states0, const void* one_tab,
                  const void* zero_tab, const void* low0,
                  const void* range0, void* packed, void* low_out,
                  void* range_out, void* states_out, int L, int N, int CC,
                  cudaStream_t stream) {
  // the state table (shared-memory instance), one_tab, zero_tab and
  // one_pow (rc_encode.py: other_smem_bytes)
  const size_t smem = (GTAB ? 0 : (size_t)CC * 32) + 512 + 256 * (BITS - 10);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rc_encode_ext_kernel<BITS, GTAB, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rc_encode_ext_kernel<BITS, GTAB, STAGES><<<L, 32, smem, stream>>>(
      (const int32_t*)ctx, (const int32_t*)diff, (const uint8_t*)active,
      (const uint8_t*)states0, (const uint8_t*)one_tab,
      (const uint8_t*)zero_tab, (const int32_t*)low0,
      (const int32_t*)range0, (int32_t*)packed, (int32_t*)low_out,
      (int32_t*)range_out, (uint8_t*)states_out, N, CC);
  return (int)cudaGetLastError();
}

#define RC_ENC_EXT_ARGS                                                    \
  ctx, diff, active, states0, one_tab, zero_tab, low0, range0, packed,     \
      low_out, range_out, states_out, L, N, CC
#define RC_ENC_EXT_PARAMS                                                  \
  const void *ctx, const void *diff, const void *active,                   \
      const void *states0, const void *one_tab, const void *zero_tab,      \
      const void *low0, const void *range0, void *packed, void *low_out,   \
      void *range_out, void *states_out, int L, int N, int CC

// Plain C entry point: returns the cudaError_t of the launch (0 = ok).
// gtab != 0 selects the table-in-global-memory instance; states_out must
// then hold a copy of states0.
extern "C" int rc_encode_ext_launch(RC_ENC_EXT_PARAMS, int bits, int gtab,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define RC_ENC_EXT_CASE(B)                                                 \
  case B:                                                                  \
    return gtab ? launch<B, true, ALL_STAGES>(RC_ENC_EXT_ARGS, s)          \
                : launch<B, false, ALL_STAGES>(RC_ENC_EXT_ARGS, s);
  switch (bits) {
    RC_ENC_EXT_CASE(11) RC_ENC_EXT_CASE(12) RC_ENC_EXT_CASE(13)
    RC_ENC_EXT_CASE(14) RC_ENC_EXT_CASE(15) RC_ENC_EXT_CASE(16)
    RC_ENC_EXT_CASE(17)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RC_ENC_EXT_CASE
}

// The stage probes: K1-ext at 16 bits with the stages of the bitmask
// ``stages`` (STAGE_*) kept and the others stubbed; timing only.  The
// variants: full (ALL_STAGES, the production instance itself), no_read,
// no_trans, no_write, no_chain, no_run and loops_only (READ | WRITE).
extern "C" int rc_encode_ext_stages_launch(RC_ENC_EXT_PARAMS, int stages,
                                           int gtab, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define RC_STAGE_CASE(M)                                                   \
  case M:                                                                  \
    return gtab ? launch<16, true, M>(RC_ENC_EXT_ARGS, s)                  \
                : launch<16, false, M>(RC_ENC_EXT_ARGS, s);
  switch (stages) {
    RC_STAGE_CASE(ALL_STAGES)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_READ)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_TRANS)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_WRITE)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_CHAIN)
    RC_STAGE_CASE(ALL_STAGES & ~STAGE_RUN)
    RC_STAGE_CASE(STAGE_READ | STAGE_WRITE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RC_STAGE_CASE
}
