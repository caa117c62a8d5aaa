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
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

template <int BITS, bool GTAB>
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
      if (t < S) out_l[(size_t)(base + j) * S + t] = my_pv;
      if (act_t) row[t] = bit_t ? one_s[mys] : zero_s[mys];
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
        rc_encode_kernel<BITS, GTAB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rc_encode_kernel<BITS, GTAB><<<L, 32, smem, stream>>>(
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
extern "C" int rc_encode_launch(
    const void* ctx, const void* diff, const void* active,
    const void* states0, const void* one_tab, const void* zero_tab,
    const void* low0, const void* range0, void* packed, void* low_out,
    void* range_out, void* states_out, int L, int N, int CC, int bits,
    int gtab, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define RC_ENC_CASE(B)                                                     \
  case B:                                                                  \
    return gtab ? launch<B, true>(ctx, diff, active, states0, one_tab,    \
                                  zero_tab, low0, range0, packed, low_out, \
                                  range_out, states_out, L, N, CC, s)      \
                : launch<B, false>(ctx, diff, active, states0, one_tab,   \
                                   zero_tab, low0, range0, packed,        \
                                   low_out, range_out, states_out, L, N,  \
                                   CC, s);
  switch (bits) {
    RC_ENC_CASE(1) RC_ENC_CASE(2) RC_ENC_CASE(3) RC_ENC_CASE(4)
    RC_ENC_CASE(5) RC_ENC_CASE(6) RC_ENC_CASE(7) RC_ENC_CASE(8)
    RC_ENC_CASE(9) RC_ENC_CASE(10)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RC_ENC_CASE
}
