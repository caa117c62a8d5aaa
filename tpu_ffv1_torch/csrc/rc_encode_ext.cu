// Adaptive range-coder lane scan (FFV1 encode), extended schedule for
// coded widths 11..17 bits (K1-ext).
//
// Replaces the Pallas TPU kernel tpu_ffv1/tpu/rc_pallas.py `_kernel`,
// extended-schedule branch (rc_pallas.py:317-389, slot order
// rc_scan_fast.ext_slots, launched by `rc_encode_pallas_packed` at
// bits > 10).  Same computation as rc_scan_lanes.rc_encode_scan_lanes_ext:
// L independent slice lanes; for each pixel read the lane's 32-byte
// context row at ctx and run the static slot walk
//
//   zero | exp j = 0..E_MAX (row 1 + min(j, 9)) | man31 r = 0..E_MAX-10
//   (row 31, bit e-1-r) | man i = 8..0 (row 22 + i) | sign (row
//   11 + min(e, 10))
//
// advancing low/range with one-step renormalisation and emitting
// provisional bytes.  put_symbol's row caps (ffv1enc.c:185-231) make rows
// 10 and 31 carry several decisions per pixel at these widths, each with
// the state the previous one left; every other position is touched at
// most once per pixel.
//
// What bounds it on the H100: as K1, the serial low/range chain, here
// 2 * BITS + 1 slot evaluations per pixel (33 at 16 bits), plus a
// dependent shared-memory load per decision on rows 10/31.  Bytes are
// few (9 B in and 4 * S B out per pixel, 141 B at 16 bits): on paper it
// is bytes-bound, in practice chain-bound.  One lane per SM: L of the
// 132 SMs work.
//
// Design: K1's, one warp per lane.  The lane's state table (CC x 32 B,
// 42,624 B at two state planes in context model 0) sits in shared
// memory; context model 1's (2 x 7,563 rows, 484,032 B) does not fit a
// block, so that instance (GTAB = true) adapts the rows in place in
// states_out, which the wrapper fills with states0, as K1's does (one
// coalesced 32-byte row read per pixel; thread t reads and writes only
// byte t).  The chain code is the same in both.  Thread t owns
// position t of the context row and reads it once per pixel; every
// thread runs the slot walk redundantly (identical values, so every
// branch is warp-uniform), reading single-touch slot states from their
// owners by shuffle.  Rows 10 and 31 are kept as running values s10/s31
// in every thread, advanced through the shared one/zero tables after each
// decision that touches them; after the pixel their owners (threads 10
// and 31) store the final values, and every other owner applies its one
// deferred transition.  S exceeds 32 at these widths, so thread k keeps
// the packed values of slots k and 32 + k.  Output offsets are size_t:
// L * N * S * 4 bytes passes 2^31 on the 1080p 16-bit path (1.64 GB).
//
// Output layout: packed int32 stored (L, N, S) (the wrapper returns it
// viewed as the Pallas contract's (N, S, L)).  An emitting slot holds
// (low >> 8) | (low & 0xFF ? 1 << 16 : 0) | 1 << 20, a silent slot 0.
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

template <int BITS, bool GTAB>
__global__ void __launch_bounds__(32) rc_encode_ext_kernel(
    const int32_t* __restrict__ ctx, const int32_t* __restrict__ diff,
    const uint8_t* __restrict__ active, const uint8_t* __restrict__ states0,
    const uint8_t* __restrict__ one_tab, const uint8_t* __restrict__ zero_tab,
    const int32_t* __restrict__ low0, const int32_t* __restrict__ range0,
    int32_t* __restrict__ packed, int32_t* __restrict__ low_out,
    int32_t* __restrict__ range_out, uint8_t* __restrict__ states_out,
    int N, int CC) {
  constexpr int E_MAX = BITS - 1;
  constexpr int N_EXP = E_MAX + 1;          // exp j = 0..E_MAX
  constexpr int N_M31 = E_MAX - 9;          // man31 r = 0..E_MAX-10
  constexpr int S = 1 + N_EXP + N_M31 + 9 + 1;
  static_assert(S == 2 * BITS + 1, "slot count");
  static_assert(S <= 64, "two packed values per thread");
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
  int32_t* out_l = packed + (size_t)lane * N * S;

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
      const int mys = row[t];
      const int a = abs(v);
      const int e = 31 - __clz(max(a, 1));
      const bool nz = v != 0;
      const int sign_p = 11 + min(e, 10);

      // this thread's single-touch position: activity and bit of its
      // one decision (positions 10 and 31 are the running rows)
      bool act_t = false;
      int bit_t = 0;
      if (t == 0) {
        act_t = ap; bit_t = !nz;
      } else if (t <= 9) {
        act_t = ap && nz && (t - 1 <= e); bit_t = (t - 1) < e;
      } else if (t >= 11 && t <= 21) {
        act_t = ap && nz && (t == sign_p); bit_t = v < 0;
      } else if (t >= 22 && t <= 30) {
        act_t = ap && nz && (t - 22 < e); bit_t = (a >> (t - 22)) & 1;
      }

      int s10 = __shfl_sync(FULL_MASK, mys, 10);
      int s31 = __shfl_sync(FULL_MASK, mys, 31);
      int my_pv0 = 0, my_pv1 = 0;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        int s, b;
        bool act;
        int run = 0;                 // 10 / 31: a running row
        if (k == 0) {
          act = ap; b = !nz;
          s = __shfl_sync(FULL_MASK, mys, 0);
        } else if (k <= N_EXP) {
          const int jj = k - 1;
          act = ap && nz && (jj <= e); b = jj < e;
          if (jj <= 8) {
            s = __shfl_sync(FULL_MASK, mys, 1 + jj);
          } else {
            s = s10; run = 10;
          }
        } else if (k <= N_EXP + N_M31) {
          const int r = k - 1 - N_EXP;
          act = ap && nz && (e >= 10 + r);
          b = (a >> min(max(e - 1 - r, 0), 31)) & 1;
          s = s31; run = 31;
        } else if (k < S - 1) {
          const int i = 8 - (k - 1 - N_EXP - N_M31);
          act = ap && nz && (i < e); b = (a >> i) & 1;
          s = __shfl_sync(FULL_MASK, mys, 22 + i);
        } else {
          act = ap && nz; b = v < 0;
          s = __shfl_sync(FULL_MASK, mys, sign_p);
        }
        const int r1 = (rng * s) >> 8;
        int nr = b ? r1 : rng - r1;
        int nl = low + (b ? rng - r1 : 0);
        const bool emit = act && nr < 0x100;
        if (emit) {
          const int pv = (nl >> 8) | ((nl & 0xFF) ? (1 << 16) : 0) | (1 << 20);
          if (k < 32) {
            if (t == k) my_pv0 = pv;
          } else {
            if (t == k - 32) my_pv1 = pv;
          }
          nl = (nl & 0xFF) << 8;
          nr <<= 8;
        }
        if (act) {
          low = nl;
          rng = nr;
          if (run == 10) s10 = b ? one_s[s10] : zero_s[s10];
          if (run == 31) s31 = b ? one_s[s31] : zero_s[s31];
        }
      }
      int32_t* px = out_l + (size_t)(base + j) * S;
      if (t < S) px[t] = my_pv0;
      if (t + 32 < S) px[t + 32] = my_pv1;
      // thread t only ever touches position t of a row, so the next
      // pixel's read of it needs no barrier
      if (t == 10) {
        row[t] = (uint8_t)s10;
      } else if (t == 31) {
        row[t] = (uint8_t)s31;
      } else if (act_t) {
        row[t] = bit_t ? one_s[mys] : zero_s[mys];
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

template <int BITS, bool GTAB>
static int launch(const void* ctx, const void* diff, const void* active,
                  const void* states0, const void* one_tab,
                  const void* zero_tab, const void* low0,
                  const void* range0, void* packed, void* low_out,
                  void* range_out, void* states_out, int L, int N, int CC,
                  cudaStream_t stream) {
  const size_t smem = (GTAB ? 0 : (size_t)CC * 32) + 512;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rc_encode_ext_kernel<BITS, GTAB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rc_encode_ext_kernel<BITS, GTAB><<<L, 32, smem, stream>>>(
      (const int32_t*)ctx, (const int32_t*)diff, (const uint8_t*)active,
      (const uint8_t*)states0, (const uint8_t*)one_tab,
      (const uint8_t*)zero_tab, (const int32_t*)low0,
      (const int32_t*)range0, (int32_t*)packed, (int32_t*)low_out,
      (int32_t*)range_out, (uint8_t*)states_out, N, CC);
  return (int)cudaGetLastError();
}

// Plain C entry point: returns the cudaError_t of the launch (0 = ok).
// gtab != 0 selects the table-in-global-memory instance; states_out must
// then hold a copy of states0.
extern "C" int rc_encode_ext_launch(
    const void* ctx, const void* diff, const void* active,
    const void* states0, const void* one_tab, const void* zero_tab,
    const void* low0, const void* range0, void* packed, void* low_out,
    void* range_out, void* states_out, int L, int N, int CC, int bits,
    int gtab, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define RC_ENC_EXT_CASE(B)                                                 \
  case B:                                                                  \
    return gtab ? launch<B, true>(ctx, diff, active, states0, one_tab,    \
                                  zero_tab, low0, range0, packed, low_out, \
                                  range_out, states_out, L, N, CC, s)      \
                : launch<B, false>(ctx, diff, active, states0, one_tab,   \
                                   zero_tab, low0, range0, packed,        \
                                   low_out, range_out, states_out, L, N,  \
                                   CC, s);
  switch (bits) {
    RC_ENC_EXT_CASE(11) RC_ENC_EXT_CASE(12) RC_ENC_EXT_CASE(13)
    RC_ENC_EXT_CASE(14) RC_ENC_EXT_CASE(15) RC_ENC_EXT_CASE(16)
    RC_ENC_EXT_CASE(17)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RC_ENC_EXT_CASE
}
