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
// What bounds it on the H100: the serial chain of VLC-coded pixels, one lane
// per warp and one warp per SM (L = 48 of the 132 SMs on the 1080p main
// path).  Bytes are few (9 in and about half a byte out per pixel); each
// VLC-coded pixel's row may be the one the VLC-coded pixel before adapted.
// Nothing else has to be on that chain: the run machine never reads the VLC
// table, and the bit position and the bytes depend on nothing after them.
// One thread issues the chain, so its time follows the chain's instruction
// count (about two cycles each, measured) as much as its latencies.
//
// The design, 32 pixels (a chunk) at a time:
//
// - The warp reads the chunk coalesced (thread t pixel base + t; the next
//   chunk's loads issue first) and turns it into ballot masks: active, the
//   plane's context 0, nonzero residual, line start, plane start, line end,
//   stream end.
// - The run machine runs on the masks in every thread alike (its values
//   are the warp's, so its branches are uniform): a run of zero residuals
//   costs one step per completed run chunk (the k-th set bit of the active
//   mask by popcounts), not one per pixel.  It yields the mask of VLC-coded
//   pixels (outside runs, and each run's break pixel), and each thread
//   keeps its own pixel's run emission (a chunk's '1' or the break code),
//   line-end flush and, at a break, its residual lowered by one where
//   positive.
// - The VLC-coded pixels go, in order (ranked by popcount), into a list in
//   shared memory, and thread 0 alone runs the chain over it: no redundant
//   copies, so no thread can read a row another has rewritten, and the
//   chain has no __syncwarp.  Every pixel's context is known in advance, so
//   the next pixel's row read issues before this pixel's updated row is
//   stored; where the two contexts are equal the chain takes the new row
//   from registers instead.  The chain keeps only the residual's fold and
//   the VlcState update: it stores each pixel's folded residual and the row
//   it was coded under, and the warp derives k and the code from them.
// - Then the warp packs the chunk: each thread joins its pixel's run
//   emission and code (at most 54 bits) and, at an active stream-end pixel,
//   the zero pad to a byte (at most 61 bits); an exclusive prefix sum of the
//   lengths by shuffles places them, and each thread ORs its bits into at
//   most three 32-bit words of a 512-byte ring (MSB first).  Golomb bytes
//   have no carry, so a whole word is final: the warp copies the ring's
//   whole words to the lane's output row after the prefix, and the bytes of
//   the last partial word at the end.  The JAX package's 9 slots per pixel
//   and its sort never exist.
// - The 17-step loop for the Golomb parameter k is a closed form from the bit
//   lengths of count and error_sum (held to the loop over every count 0..129
//   and error_sum 0..0xFFFF in tests/test_torch_golomb.py); ff_log2_run is a
//   closed form too, 0 at indices >= 41 as the JAX scan's one-hot gives.
//   Both, and the VlcState update, are in csrc/golomb_vlc.cuh, which G2 and
//   the pixel-step probe share.
//
// Table placement: the lane's VLC table (CC rows of 16 B: 21,312 B at context
// model 0), the ring and the chunk's list (each VLC-coded pixel's context and
// residual, then its folded residual and row) live in shared memory.  Context model 1's table (2
// x 7,563 rows, 242,016 B) does not fit a block: the GTAB instance keeps it
// in global memory, adapted in place in vlc_out, which the wrapper fills with
// vlc0; the chain code is the same.  The context index is clamped into the
// table.
//
// Stage probes (STAGES != ALL_STAGES, reached through
// golomb_encode_stages_launch and never by the codec): the same kernel with
// one stage stubbed, for timing only (their outputs are wrong on purpose).
// READ: the chunk's input read (stubbed: pixels made from their index, no
// runs); RUN: the run machine (stubbed: every active pixel VLC-coded);
// VLC: the row read, code and update (stubbed: a fixed-length code of
// `bits`); PACK: the bit packing and the stores (stubbed: a checksum of the
// emissions).  The production instances are ALL_STAGES.
#include <cuda_runtime.h>
#include <stdint.h>

#include "golomb_vlc.cuh"  // log2_run, vlc_k, update_vlc

#define FULL_MASK 0xffffffffu

enum : int {
  STAGE_READ = 1,
  STAGE_RUN = 2,
  STAGE_VLC = 4,
  STAGE_PACK = 8,
  ALL_STAGES = 15
};

enum : int {
  FLAG_LINE_START = 1,
  FLAG_LINE_END = 2,
  FLAG_PLANE_START = 4,
  FLAG_STREAM_END = 8,
  FLAG_SPLANE_SHIFT = 4,
  RING_WORDS = 128,        // output ring of 32-bit words (512 B)
  LIST = 34,               // a chunk's VLC-coded pixels, and two read ahead
  // shared memory beside the table: the ring, the list of the chunk's
  // VLC-coded pixels (context, residual) and their symbols and rows
  OTHER_SMEM = RING_WORDS * 4 + LIST * 8 + 32 * 16
};

// bits [0, e) of a word (every bit for e >= 32)
__device__ __forceinline__ unsigned below(int e) {
  return e >= 32 ? FULL_MASK : (1u << e) - 1;
}

// the lowest set bit of m, or 32 where m is 0
__device__ __forceinline__ int first_bit(unsigned m) {
  return m ? __ffs((int)m) - 1 : 32;
}

// the position of the k-th (from 0) set bit of m, k < popc(m)
__device__ __forceinline__ int nth_bit(unsigned m, int k) {
  int p = 0, c;
  c = __popc(m & 0xFFFFu);
  if (k >= c) { k -= c; m >>= 16; p += 16; }
  c = __popc(m & 0xFFu);
  if (k >= c) { k -= c; m >>= 8; p += 8; }
  c = __popc(m & 0xFu);
  if (k >= c) { k -= c; m >>= 4; p += 4; }
  c = __popc(m & 0x3u);
  if (k >= c) { k -= c; m >>= 2; p += 2; }
  return p + (k >= (int)(m & 1u) ? 1 : 0);
}

template <bool GTAB, int STAGES>
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
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + (GTAB ? 0 : CC * 16));
  // the chunk's VLC-coded pixels in order: (clamped context, residual),
  // two entries past the last read ahead (every entry, stale or not, holds
  // a context inside the table); then each one's folded residual and the
  // row it was coded under (vf, drift, count, error_sum)
  int2* list_s = reinterpret_cast<int2*>(ring + RING_WORDS);
  int4* code_s = reinterpret_cast<int4*>(list_s + LIST);
  if (!GTAB) {
    const int4* src = reinterpret_cast<const int4*>(vlc0) + (size_t)lane * CC;
    for (int i = t; i < CC; i += 32) st[i] = src[i];
  }
  for (int i = t; i < RING_WORDS; i += 32) ring[i] = 0;
  for (int i = t; i < LIST; i += 32) list_s[i] = make_int2(0, 0);
  uint8_t* out_l = out + (size_t)lane * T;
  const int plen = plens[lane];
  for (int i = t; i < plen && i < T; i += 32)
    out_l[i] = (uint8_t)prefixes[(size_t)lane * pcap + i];
  uint8_t* pay = out_l + plen;            // the payload's bytes
  const int room = T - plen;              // of which fit the row
  const int32_t* ctx_l = ctx + (size_t)lane * N;
  const int32_t* diff_l = diff + (size_t)lane * N;
  const uint8_t* act_l = act + (size_t)lane * N;
  const int mask_v = (1 << bits) - 1, half = 1 << (bits - 1);
  int bitpos = 0;                         // payload bits placed
  int flushed = 0;                        // payload words copied out
  unsigned long long chk = 0;             // stage probe no_pack
  int run_index = 0, run_mode = 0, run_count = 0;   // the run machine
  // pixel i of the lane, read ahead: its context, residual, flags, active
  auto read = [&](int i, int& c, int& d, int& fl, bool& ac) {
    c = d = fl = 0;
    ac = false;
    if (i >= N) return;
    if constexpr ((STAGES & STAGE_READ) != 0) {
      c = ctx_l[i];
      d = diff_l[i];
      fl = flags[i];
      ac = act_l[i] != 0;
    } else {                              // stub: pixels from their index
      const unsigned h = (unsigned)i * 2654435761u;
      c = 1 + (int)((h >> 8) % (unsigned)(cc > 1 ? cc - 1 : 1));
      d = (int)((h >> 4) & 7) - 3;
      fl = i == N - 1 ? FLAG_STREAM_END : 0;
      ac = true;
    }
  };
  int cv_nx, dv_nx, f_nx;
  bool a_nx;
  read(t, cv_nx, dv_nx, f_nx, a_nx);
  __syncwarp();

  for (int base = 0; base < N; base += 32) {
    const int n = min(32, N - base);
    // the chunk, coalesced: thread t holds pixel base + t; the next
    // chunk's loads issue now, to land while this one is coded
    const int cv = cv_nx, f = f_nx;
    int dv = dv_nx;
    const bool a = a_nx;
    read(base + 32 + t, cv_nx, dv_nx, f_nx, a_nx);
    const unsigned act_m = __ballot_sync(FULL_MASK, a);
    const unsigned zero_ctx_m = __ballot_sync(
        FULL_MASK, a && cv == ((f & 0xFFFF) >> FLAG_SPLANE_SHIFT) * cc);
    const unsigned nz_m = __ballot_sync(FULL_MASK, a && dv != 0);
    const unsigned ls_m = __ballot_sync(FULL_MASK, f & FLAG_LINE_START);
    const unsigned ps_m = __ballot_sync(FULL_MASK, f & FLAG_PLANE_START);
    const unsigned le_m = __ballot_sync(FULL_MASK, a && (f & FLAG_LINE_END));
    const unsigned se_m = __ballot_sync(FULL_MASK,
                                        a && (f & FLAG_STREAM_END));

    // the run machine, in every thread alike (its values are the warp's):
    // pixel j is the next one to code, its line and plane flags applied
    // unless `fresh`; thread t keeps its own pixel's run emission (a run
    // chunk's '1' or the break code) and line-end flush
    unsigned vlc_m = act_m;
    int run_len = 0, flush = 0;
    unsigned run_val = 0;
    if constexpr ((STAGES & STAGE_RUN) != 0) {
      vlc_m = 0;
      int j = 0;
      bool fresh = true;
      while (j < n) {
        if (run_mode && fresh) {
          if ((ls_m >> j) & 1) {
            run_mode = 0;
            run_count = 0;
          }
          if ((ps_m >> j) & 1) run_index = 0;
        }
        if (!run_mode) {
          // VLC-coded up to the next pixel of the plane's context 0, which
          // enters run mode (after its own flags)
          const unsigned rest = FULL_MASK << j;
          const int e = min(first_bit(zero_ctx_m & rest), n);
          if (ps_m & rest & below(e + 1)) run_index = 0;
          vlc_m |= act_m & rest & below(e);
          if (e == n) break;
          run_mode = 1;                   // run_count is 0 outside runs
          j = e;
        }
        // in run mode at j, its flags applied: zero residuals up to the
        // break (an active nonzero residual), the next line or plane start,
        // or just after an active line end (the flush)
        const unsigned from = FULL_MASK << j;
        const int b = first_bit(nz_m & from);
        const int g =
            j < 31 ? first_bit((ls_m | ps_m) & (FULL_MASK << (j + 1))) : 32;
        const int fl = first_bit(le_m & ~nz_m & from);
        const int end = fl < min(b, g) ? fl + 1 : min(min(b, g), n);
        unsigned zeros = act_m & from & below(end);
        for (;;) {                        // each completed run chunk: '1'
          const int need = (1 << log2_run(run_index)) - run_count;
          if (__popc(zeros) < need) break;
          const int p = nth_bit(zeros, need - 1);
          if (t == p) {
            run_len = 1;
            run_val = 1;
          }
          zeros &= p < 31 ? FULL_MASK << (p + 1) : 0;
          run_count = 0;
          ++run_index;
        }
        run_count += __popc(zeros);
        fresh = true;
        if (fl < min(b, g)) {             // the line ends inside the run
          if (t == fl && run_count > 0) flush = 1;
          j = fl + 1;
        } else if (b < g) {               // the break: '0' + run_count
          if (t == b) {
            run_len = 1 + log2_run(run_index);
            run_val = (unsigned)run_count;
            if (dv > 0) --dv;
          }
          if (run_index > 0) --run_index;
          run_count = 0;
          run_mode = 0;
          vlc_m |= 1u << b;
          j = b + 1;
        } else {
          j = end;                        // g, or the chunk's end
        }
      }
    }
    // the VLC-coded pixels, in order, for thread 0
    const bool coded = (vlc_m >> t) & 1;
    const int rank = __popc(vlc_m & below(t));
    const int nv = __popc(vlc_m);
    if (coded) list_s[rank] = make_int2(min(max(cv, 0), CC - 1), dv);
    __syncwarp();
    if (t == 0 && nv > 0) {
      // the serial chain: the next pixel's row read issues before this
      // pixel's store; where the contexts are equal, this pixel's new row
      // is taken from registers
      int2 e = list_s[0], en = list_s[1];
      int4 row = make_int4(0, 0, 0, 0);
      if constexpr ((STAGES & STAGE_VLC) != 0) row = st[e.x];
      for (int i = 0;;) {
        const int2 enn = list_s[i + 2];
        if constexpr ((STAGES & STAGE_VLC) != 0) {
          const int4 loaded = st[en.x];
          const int vf = ((e.y - row.z + half) & mask_v) - half;
          code_s[i] = make_int4(vf, row.x, row.w, row.y);
          const int4 nrow = update_vlc(row, vf);
          st[e.x] = nrow;
          row = en.x == e.x ? nrow : loaded;
        } else {                          // stub: a fixed-length code
          code_s[i] = make_int4(e.y & mask_v, 0, 1, 1 << bits);  // k = bits
        }
        if (++i == nv) break;
        e = en;
        en = enn;
      }
    }
    __syncwarp();

    // this thread's pixel's bits: its run emission, then its code or flush
    int len = run_len;
    unsigned long long val = run_val;
    if (coded) {
      const int4 sym = code_s[rank];    // vf, drift, count, error_sum
      const int code = 2 * sym.y + sym.z < 0 ? ~sym.x : sym.x;
      const int code2 = code >= 0 ? 2 * code : -2 * code - 1;
      const int k = vlc_k(sym.z, sym.w);
      const bool esc = (code2 >> k) >= 12;    // escape: limit 12
      const int cl = esc ? 12 + bits : (code2 >> k) + k + 1;
      const unsigned cval = esc ? (unsigned)(code2 - 11)
                                : (1u << k) + (unsigned)(code2 & ((1 << k) - 1));
      len += cl;
      val = (val << cl) | cval;
    } else if (flush) {
      len += 1;
      val = (val << 1) | 1u;
    }
    if constexpr ((STAGES & STAGE_PACK) == 0) {
      chk = chk * 31 + val + (unsigned)len;   // stub: no packing
      continue;
    }
    // the exclusive prefix sum of the lengths places them
    int incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl, d);
      if (t >= d) incl += y;
    }
    int excl = incl - len;
    int total = __shfl_sync(FULL_MASK, incl, 31);
    // an active stream-end pixel pads the stream to a byte after its bits
    for (unsigned m = se_m; m; m &= m - 1) {
      const int p = __ffs((int)m) - 1;
      const int pad = -(bitpos + __shfl_sync(FULL_MASK, excl + len, p)) & 7;
      if (t == p) {
        len += pad;
        val <<= pad;
      } else if (t > p) {
        excl += pad;
      }
      total += pad;
    }
    if (len > 0) {                        // at most 61 bits: three words
      const int pos = bitpos + excl, off = pos & 31, wi = pos >> 5;
      const unsigned long long al = val << (64 - len);   // left-aligned
      atomicOr(&ring[wi & (RING_WORDS - 1)], (uint32_t)(al >> (32 + off)));
      const uint32_t w1 = (uint32_t)(al >> off);
      const uint32_t w2 = off ? (uint32_t)(al << (32 - off)) : 0u;
      if (w1) atomicOr(&ring[(wi + 1) & (RING_WORDS - 1)], w1);
      if (w2) atomicOr(&ring[(wi + 2) & (RING_WORDS - 1)], w2);
    }
    bitpos += total;
    __syncwarp();
    // the ring's whole words to the output, MSB first; each copied word is
    // cleared for its next turn
    const int whole = bitpos >> 5;
    for (int wi = flushed + t; wi < whole; wi += 32) {
      const uint32_t w = ring[wi & (RING_WORDS - 1)];
      ring[wi & (RING_WORDS - 1)] = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * wi + k < room) pay[4 * wi + k] = (uint8_t)(w >> (24 - 8 * k));
    }
    flushed = whole;
    __syncwarp();
  }
  if constexpr ((STAGES & STAGE_PACK) == 0) {
    for (int d = 16; d > 0; d >>= 1) chk ^= __shfl_xor_sync(FULL_MASK, chk, d);
    bitpos = (int)(chk & 0xFF) * 8;
  }
  // the last partial word's whole bytes
  if (t < 4 && 4 * flushed + t < (bitpos >> 3) && 4 * flushed + t < room)
    pay[4 * flushed + t] =
        (uint8_t)(ring[flushed & (RING_WORDS - 1)] >> (24 - 8 * t));
  if (t == 0) {
    counts[lane] = plen + (bitpos >> 3);
    run_index_out[lane] = run_index;
  }
  if (!GTAB) {
    __syncwarp();
    int4* dst = reinterpret_cast<int4*>(vlc_out) + (size_t)lane * CC;
    for (int i = t; i < CC; i += 32) dst[i] = st[i];
  }
}

template <bool GTAB, int STAGES>
static int launch(const void* ctx, const void* diff, const void* act,
                  const void* flags, const void* vlc0, const void* prefixes,
                  const void* plens, void* out, void* counts, void* vlc_out,
                  void* run_index, int L, int N, int CC, int pcap, int T,
                  int bits, int cc, cudaStream_t stream) {
  const size_t smem = (GTAB ? 0 : (size_t)CC * 16) + OTHER_SMEM;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        golomb_encode_kernel<GTAB, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  golomb_encode_kernel<GTAB, STAGES><<<L, 32, smem, stream>>>(
      (const int32_t*)ctx, (const int32_t*)diff, (const uint8_t*)act,
      (const int32_t*)flags, (const int32_t*)vlc0, (const int32_t*)prefixes,
      (const int32_t*)plens, (uint8_t*)out, (int32_t*)counts,
      (int32_t*)vlc_out, (int32_t*)run_index, N, CC, pcap, T, bits, cc);
  return (int)cudaGetLastError();
}

// Plain C entry point: returns the cudaError_t of the launch (0 = ok).  out
// is (L, T) bytes, zeroed by the caller; gtab != 0 selects the
// table-in-global-memory instance, where vlc_out must hold a copy of vlc0.
#define GOLOMB_ENC_PARAMS                                                 \
  const void *ctx, const void *diff, const void *act, const void *flags,  \
      const void *vlc0, const void *prefixes, const void *plens, void *out, \
      void *counts, void *vlc_out, void *run_index, int L, int N, int CC,   \
      int pcap, int T, int bits, int cc
#define GOLOMB_ENC_ARGS                                                    \
  ctx, diff, act, flags, vlc0, prefixes, plens, out, counts, vlc_out,     \
      run_index, L, N, CC, pcap, T, bits, cc
extern "C" int golomb_encode_launch(GOLOMB_ENC_PARAMS, int gtab,
                                    void* stream) {
  if (bits < 1 || bits > 16 || N < 1 || CC < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return gtab ? launch<true, ALL_STAGES>(GOLOMB_ENC_ARGS, s)
              : launch<false, ALL_STAGES>(GOLOMB_ENC_ARGS, s);
}

// The stage probes: golomb_encode_launch's arguments and the STAGES kept.
extern "C" int golomb_encode_stages_launch(GOLOMB_ENC_PARAMS, int gtab,
                                           int stages, void* stream) {
  if (bits < 1 || bits > 16 || N < 1 || CC < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define GOLOMB_STAGE_CASE(M)                                               \
  case M:                                                                  \
    return gtab ? launch<true, M>(GOLOMB_ENC_ARGS, s)                      \
                : launch<false, M>(GOLOMB_ENC_ARGS, s);
  switch (stages) {
    GOLOMB_STAGE_CASE(ALL_STAGES)
    GOLOMB_STAGE_CASE(ALL_STAGES & ~STAGE_READ)
    GOLOMB_STAGE_CASE(ALL_STAGES & ~STAGE_RUN)
    GOLOMB_STAGE_CASE(ALL_STAGES & ~STAGE_VLC)
    GOLOMB_STAGE_CASE(ALL_STAGES & ~STAGE_PACK)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GOLOMB_STAGE_CASE
}
