// The VLC coder's per-symbol rules, shared by the Golomb-Rice lane scans
// (golomb_encode.cu, G1; golomb_decode.cu, G2) and their pixel-step probe
// (chain_probe.cu, golomb_step_kernel).  Included after the includer's
// <cuda_runtime.h> (or, under tools/warp_emu, its stand-in), so it includes
// nothing itself.
#pragma once

// ff_log2_run (bitstream.c:40-48): 4 x {0..3}, 2 x {4..7}, then 8..24; 0 past
// index 40
__device__ __forceinline__ int log2_run(int i) {
  return i < 16 ? i >> 2 : i < 24 ? 4 + ((i - 16) >> 1) : i < 41 ? i - 16 : 0;
}

// the smallest k <= 17 with count << k >= error_sum (17 steps of doubling),
// without a branch: the serial chains that use it issue one instruction at
// a time
__device__ __forceinline__ int vlc_k(int count, int esum) {
  const int a = 32 - __clz(count), b = 32 - __clz(esum);
  int k = max(b - a, 0);
  k += (count << k) < esum;
  k = min(k, 17);
  return count == 0 ? (esum > 0 ? 17 : 0) : k;
}

// update_vlc_state (ffv1.h:192-224): the row (drift, error_sum, bias, count)
// after the symbol v, as selects (no branch)
__device__ __forceinline__ int4 update_vlc(int4 row, int v) {
  const bool halve = row.w == 128;
  int nesum = (row.y + (v < 0 ? -v : v)) & 0xFFFF;
  int ndrift = row.x + v;
  nesum = halve ? nesum >> 1 : nesum;
  ndrift = halve ? ndrift >> 1 : ndrift;
  const int ncount = (halve ? 64 : row.w) + 1;
  const bool neg = ndrift <= -ncount;
  const bool pos = !neg && ndrift > 0;
  const int nbias = row.z - (neg && row.z > -128 ? 1 : 0) +
                    (pos && row.z < 127 ? 1 : 0);
  ndrift = neg ? max(ndrift + ncount, 1 - ncount)
               : pos ? min(ndrift - ncount, 0) : ndrift;
  return make_int4(ndrift, nesum, nbias, ncount);
}
