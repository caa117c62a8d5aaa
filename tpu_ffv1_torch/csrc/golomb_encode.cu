// Golomb-Rice encode lane scan (FFV1 coder=0, the reference's default coder):
// G1.
//
// Replaces the XLA scan of the JAX package, tpu_ffv1/tpu/golomb_scan.py
// `golomb_encode_scan_lanes` and its byte compaction `finalize_bytes` (no
// Pallas kernel: lax.scan over pixels, vectorised over lanes).  Same
// computation: for each of L slice lanes, pixel-serial, the per-line run-mode
// state machine (run chunks of 2^log2_run[run_index], the break code, the
// line-end flush), the VLC symbol of each pixel outside a run under its
// context's adaptive VlcState (drift, error_sum, bias, count: the row is read,
// coded with limit 12 and esc_len = bits, and adapted), and the MSB-first bit
// packing after the lane's prefix (the range-coded slice header), the last
// byte zero-padded at the stream's end.  Behaviour of ffv1enc.c:326-367,
// golomb.h:506-561 (set_ur_golomb, set_sr_golomb) and ffv1.h:192-224
// (update_vlc_state).  Run bits are emitted eagerly, as the JAX scan emits
// them: a run chunk's '1' when the chunk completes, which is the reference's
// bit sequence (golomb_scan.py:12-23).
//
// What bounds it on the H100: the serial chain, one lane per warp and one
// warp per SM (L = 48 of the 132 SMs on the 1080p main path).  Bytes are few
// (9 in and about half a byte out per pixel); each pixel's VlcState row may be
// the one the pixel before adapted, the run state and the bit position carry
// from pixel to pixel, so a pixel costs the latency of its row read, its
// update and the packing, one after the other.
//
// What the design does about it (a first version, simple and exact):
//
// - Every thread runs the chain redundantly (the values are identical, so
//   every branch is warp-uniform), with the bit accumulator in a 64-bit
//   register: an emission of at most 28 bits joins at most 7 pending ones,
//   with no 16-bit halves.
// - Off the chain, the warp reads the next 32 pixels' ctx, diff, active and
//   flags coalesced (thread t pixel base + t), and the chain takes pixel j's
//   by three shuffles.
// - Golomb bytes have no carry, so they are final when written: the chain
//   writes each byte into a 512-byte ring in shared memory (every thread the
//   same byte), and after each 32 pixels the warp copies the ring's whole
//   32-byte pieces to the lane's output row, the prefix first.  The JAX
//   package's 9 slots per pixel and its sort never exist.
// - The 17-step loop for the Golomb parameter k is a closed form from the bit
//   lengths of count and error_sum (held to the loop over every count 0..129
//   and error_sum 0..0xFFFF in tests/test_torch_golomb.py); ff_log2_run is a
//   closed form too, 0 at indices >= 41 as the JAX scan's one-hot gives.
//   Both, and the VlcState update, are in csrc/golomb_vlc.cuh, which G2 and
//   the pixel-step probe share.
//
// Table placement: the lane's VLC table (CC rows of 16 B: 21,312 B at context
// model 0) and the ring live in shared memory.  Context model 1's table (2 x
// 7,563 rows, 242,016 B) does not fit a block: the GTAB instance keeps it in
// global memory, adapted in place in vlc_out, which the wrapper fills with
// vlc0; the chain code is the same.  The context index is clamped into the
// table.
#include <cuda_runtime.h>
#include <stdint.h>

#include "golomb_vlc.cuh"  // log2_run, vlc_k, update_vlc

#define FULL_MASK 0xffffffffu

enum : int {
  FLAG_LINE_START = 1,
  FLAG_LINE_END = 2,
  FLAG_PLANE_START = 4,
  FLAG_STREAM_END = 8,
  FLAG_SPLANE_SHIFT = 4,
  FLAG_ACTIVE = 1 << 16,   // the pixel's active bit, beside its flags
  RING = 512               // output byte ring
};

template <bool GTAB>
__global__ void __launch_bounds__(32) golomb_encode_kernel(
    const int32_t* __restrict__ ctx, const int32_t* __restrict__ diff,
    const uint8_t* __restrict__ act, const int32_t* __restrict__ flags,
    const int32_t* __restrict__ vlc0, const int32_t* __restrict__ prefixes,
    const int32_t* __restrict__ plens, uint8_t* __restrict__ out,
    int32_t* __restrict__ counts, int32_t* __restrict__ vlc_out,
    int32_t* __restrict__ run_index_out, int N, int CC, int pcap, int T,
    int bits, int cc) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  // CC x 4 VLC table: shared memory, or the lane's rows of vlc_out
  int4* st = GTAB ? reinterpret_cast<int4*>(vlc_out) + (size_t)lane * CC
                  : reinterpret_cast<int4*>(smem);
  uint8_t* ring = smem + (GTAB ? 0 : CC * 16);
  if (!GTAB) {
    const int4* src = reinterpret_cast<const int4*>(vlc0) + (size_t)lane * CC;
    for (int i = t; i < CC; i += 32) st[i] = src[i];
  }
  uint8_t* out_l = out + (size_t)lane * T;
  const int plen = plens[lane];
  for (int i = t; i < plen && i < T; i += 32)
    out_l[i] = (uint8_t)prefixes[(size_t)lane * pcap + i];
  const int32_t* ctx_l = ctx + (size_t)lane * N;
  const int32_t* diff_l = diff + (size_t)lane * N;
  const uint8_t* act_l = act + (size_t)lane * N;
  const int mask_v = (1 << bits) - 1, half = 1 << (bits - 1);
  int nbytes = plen, flushed = plen;   // bytes written; bytes in out
  unsigned long long acc = 0;          // the pending bits, nacc < 8 of them
  int nacc = 0;
  // one emission of n <= 28 bits of v (v < 2^n), MSB first, into the ring
  auto put = [&](int n, unsigned v) {
    acc = (acc << n) | v;
    nacc += n;
    while (nacc >= 8) {
      nacc -= 8;
      ring[nbytes & (RING - 1)] = (uint8_t)(acc >> nacc);
      ++nbytes;
    }
    acc &= (1ull << nacc) - 1;
  };
  int run_index = 0, run_mode = 0, run_count = 0;
  __syncwarp();

  for (int base = 0; base < N; base += 32) {
    // the next 32 pixels, coalesced: thread t holds pixel base + t
    int cv = 0, dv = 0, fv = 0;
    if (base + t < N) {
      cv = ctx_l[base + t];
      dv = diff_l[base + t];
      fv = flags[base + t] | (act_l[base + t] ? FLAG_ACTIVE : 0);
    }
    const int n = min(32, N - base);
    for (int j = 0; j < n; ++j) {
      const int c = __shfl_sync(FULL_MASK, cv, j);
      int v = __shfl_sync(FULL_MASK, dv, j);
      const int f = __shfl_sync(FULL_MASK, fv, j);
      const bool a = (f & FLAG_ACTIVE) != 0;
      if (f & FLAG_PLANE_START) run_index = 0;
      if (f & FLAG_LINE_START) {
        run_mode = 0;
        run_count = 0;
      }
      // run mode on the plane's context 0 (ffv1enc.c:331)
      if (a && c == ((f & 0xFFFF) >> FLAG_SPLANE_SHIFT) * cc) run_mode = 1;
      if (run_mode == 1 && a) {
        if (v == 0) {                  // the run goes on; a chunk completes
          if (run_count + 1 == (1 << log2_run(run_index))) {
            put(1, 1);
            run_count = 0;
            ++run_index;
          } else {
            ++run_count;
          }
        } else {                       // the break: '0' + run_count
          put(1 + log2_run(run_index), (unsigned)run_count);
          if (run_index > 0) --run_index;
          run_count = 0;
          run_mode = 0;
          if (v > 0) --v;
        }
      }
      if (a && run_mode == 0) {        // the VLC symbol
        int4* rowp = st + min(max(c, 0), CC - 1);
        const int4 row = *rowp;
        const int drift = row.x, esum = row.y, bias = row.z, count = row.w;
        const int vf = ((v - bias + half) & mask_v) - half;
        const int k = vlc_k(count, esum);
        const int code = 2 * drift + count < 0 ? ~vf : vf;
        const int code2 = code >= 0 ? 2 * code : -2 * code - 1;
        if ((code2 >> k) >= 12)        // escape: limit 12, esc_len = bits
          put(12 + bits, (unsigned)(code2 - 11));
        else
          put((code2 >> k) + k + 1,
              (1u << k) + (unsigned)(code2 & ((1 << k) - 1)));
        const int4 nrow = update_vlc(row, vf);
        // every thread read the row before any writes it (each thread writes
        // the same values, and reads back what it wrote)
        __syncwarp();
        *rowp = nrow;
      } else if ((f & FLAG_LINE_END) && run_mode == 1 && run_count > 0 && a) {
        put(1, 1);                     // the line ends inside a run
      }
      if ((f & FLAG_STREAM_END) && a && nacc > 0) put(8 - nacc, 0);
    }
    // the ring's whole 32-byte pieces to the output
    __syncwarp();
    for (; nbytes - flushed >= 32; flushed += 32) {
      const int p = flushed + t;
      if (p < T) out_l[p] = ring[p & (RING - 1)];
    }
    __syncwarp();
  }
  for (int p = flushed + t; p < nbytes; p += 32)
    if (p < T) out_l[p] = ring[p & (RING - 1)];
  if (t == 0) {
    counts[lane] = nbytes;
    run_index_out[lane] = run_index;
  }
  if (!GTAB) {
    int4* dst = reinterpret_cast<int4*>(vlc_out) + (size_t)lane * CC;
    for (int i = t; i < CC; i += 32) dst[i] = st[i];
  }
}

template <bool GTAB>
static int launch(const void* ctx, const void* diff, const void* act,
                  const void* flags, const void* vlc0, const void* prefixes,
                  const void* plens, void* out, void* counts, void* vlc_out,
                  void* run_index, int L, int N, int CC, int pcap, int T,
                  int bits, int cc, cudaStream_t stream) {
  const size_t smem = (GTAB ? 0 : (size_t)CC * 16) + RING;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        golomb_encode_kernel<GTAB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  golomb_encode_kernel<GTAB><<<L, 32, smem, stream>>>(
      (const int32_t*)ctx, (const int32_t*)diff, (const uint8_t*)act,
      (const int32_t*)flags, (const int32_t*)vlc0, (const int32_t*)prefixes,
      (const int32_t*)plens, (uint8_t*)out, (int32_t*)counts,
      (int32_t*)vlc_out, (int32_t*)run_index, N, CC, pcap, T, bits, cc);
  return (int)cudaGetLastError();
}

// Plain C entry point: returns the cudaError_t of the launch (0 = ok).  out
// is (L, T) bytes, zeroed by the caller; gtab != 0 selects the
// table-in-global-memory instance, where vlc_out must hold a copy of vlc0.
extern "C" int golomb_encode_launch(const void* ctx, const void* diff,
                                    const void* act, const void* flags,
                                    const void* vlc0, const void* prefixes,
                                    const void* plens, void* out,
                                    void* counts, void* vlc_out,
                                    void* run_index, int L, int N, int CC,
                                    int pcap, int T, int bits, int cc,
                                    int gtab, void* stream) {
  if (bits < 1 || bits > 16 || N < 1 || CC < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return gtab ? launch<true>(ctx, diff, act, flags, vlc0, prefixes, plens,
                             out, counts, vlc_out, run_index, L, N, CC, pcap,
                             T, bits, cc, s)
              : launch<false>(ctx, diff, act, flags, vlc0, prefixes, plens,
                              out, counts, vlc_out, run_index, L, N, CC,
                              pcap, T, bits, cc, s);
}
