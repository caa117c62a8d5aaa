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

// the smallest k <= 17 with count << k >= error_sum (17 steps of doubling)
__device__ __forceinline__ int vlc_k(int count, int esum) {
  if (count == 0) return esum > 0 ? 17 : 0;
  const int a = 32 - __clz(count), b = 32 - __clz(esum);
  int k = max(b - a, 0);
  k += (count << k) < esum;
  return min(k, 17);
}

// update_vlc_state (ffv1.h:192-224): the row (drift, error_sum, bias, count)
// after the symbol v
__device__ __forceinline__ int4 update_vlc(int4 row, int v) {
  int nesum = (row.y + (v < 0 ? -v : v)) & 0xFFFF;
  int ndrift = row.x + v;
  int ncount = row.w;
  if (ncount == 128) {
    ncount = 64;
    ndrift >>= 1;
    nesum >>= 1;
  }
  ++ncount;
  int nbias = row.z;
  if (ndrift <= -ncount) {
    if (row.z > -128) --nbias;
    ndrift += ncount;
    if (ndrift <= -ncount) ndrift = 1 - ncount;
  } else if (ndrift > 0) {
    if (row.z < 127) ++nbias;
    ndrift -= ncount;
    if (ndrift > 0) ndrift = 0;
  }
  return make_int4(ndrift, nesum, nbias, ncount);
}
