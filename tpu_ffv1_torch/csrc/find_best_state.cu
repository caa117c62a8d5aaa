// find_best_state: the two-pass encoder's table of tuned initial states
// (ffv1enc.c:139-183), as the host C tier computes it
// (native/ffv1_native.c:850 ffv1n_find_best_state).
//
// Replaces no Pallas kernel: the JAX package runs this dynamic program on
// the host, as a scalar double fold in its C tier (a float64 fallback in
// tpu_ffv1/codec/twopass.py:164 is not exact).  For a one-bit probability
// p = i / 256 and each candidate initial state j = i - 10 .. i + 10
// (one_state[j] != 0), a distribution occ over the 256 adaptive states
// starts at j; step k = 0..255 adds the expected cost of one bit,
//   len -= occ[m] * (p * l2tab[m] + (1 - p) * l2tab[256 - m]), m = 1..255,
// to len, keeps it as lens[(i, j), k], and moves occ one bit on:
//   nocc[one_state[m]] += occ[m] * p;
//   nocc[256 - one_state[256 - m]] += occ[m] * (1 - p).
// best_state[i][k] is the first j (ascending) with the least lens[(i, j),
// k] (a strict < over j, as the C).
//
// Exactness: the table must equal the host's bit for bit, and the host's
// result follows the order and the rounding of every double operation
// (a tie of two candidates' len flips on one ulp).  So:
// - each thread runs one (i, j) row's fold with the C's order of m and k;
// - every product and sum is an explicit __dmul_rn / __dadd_rn: nvcc
//   would otherwise contract a * b + c into an FMA, which rounds once
//   where the host's gcc -O3 (x86-64, no -march, so no FMA) rounds twice;
// - l2tab comes in from the host's libm (math.log2), not CUDA's log2;
// - nocc is 257 wide: one_state[256 - m] = 0 reaches index 256, which the
//   C writes past its array and never reads; the column is dropped here.
//
// What bounds it on the H100: neither bytes (256 B in, 64 KB out, the
// 11 MB of lens written and read once) nor the card's FP64 rate, but
// latency: 5,376 rows, each a serial chain of 256 x 255 steps over
// arrays in local memory (occ and nocc, 4 KB a thread, L1-resident), on
// at most 168 warps.  The design keeps it simple and exact: one thread a
// row (rows run in parallel, never their steps), a term skipped where
// occ[m] is 0 as the C skips it, and a second kernel for the pick, one
// thread per (i, k) over its 21 candidates in order.
#include <cuda_runtime.h>
#include <stdint.h>

// the candidates j = i - 10 .. i + 10 of a probability i
constexpr int kSpan = 21;

// the (i, j) row of thread `row` (row = i * SPAN + d, j = i - 10 + d), or
// -1 for none
template <int SPAN>
__device__ __forceinline__ int candidate(int row, const uint8_t* one) {
  const int i = row / SPAN;
  const int j = i - 10 + row % SPAN;
  return (j >= 1 && j <= 255 && one[j]) ? j : -1;
}

// COUNT: also add the number of terms folded (the (k, m) with occ[m] != 0)
// to *terms, for the roofline bound of a measurement
template <int SPAN, bool COUNT>
__global__ void __launch_bounds__(32) fold_kernel(
    const uint8_t* __restrict__ one_state, const double* __restrict__ l2tab,
    double* __restrict__ lens, unsigned long long* __restrict__ terms) {
  extern __shared__ __align__(16) uint8_t smem[];
  double* l2 = reinterpret_cast<double*>(smem);
  uint8_t* one = smem + 256 * sizeof(double);
  const int t = threadIdx.x;
  for (int m = t; m < 256; m += 32) {
    l2[m] = l2tab[m];
    one[m] = one_state[m];
  }
  __syncwarp();
  const int row = blockIdx.x * 32 + t;
  if (row >= 256 * SPAN) return;
  const int j = candidate<SPAN>(row, one);
  if (j < 0) return;
  const double p = (row / SPAN) / 256.0;     // exact: a power-of-2 divisor
  const double q = __dadd_rn(1.0, -p);
  double buf[2][257];
  double* occ = buf[0];
  double* nocc = buf[1];
  for (int m = 0; m < 257; ++m) occ[m] = 0.0;
  occ[j] = 1.0;
  double len = 0.0;
  unsigned long long n = 0;
  double* out = lens + (size_t)row * 256;
  for (int k = 0; k < 256; ++k) {
    for (int m = 1; m < 256; ++m) {
      const double o = occ[m];
      if (o != 0.0) {
        if constexpr (COUNT) ++n;
        const double c = __dadd_rn(__dmul_rn(p, l2[m]),
                                   __dmul_rn(q, l2[256 - m]));
        len = __dadd_rn(len, -__dmul_rn(o, c));
      }
    }
    out[k] = len;
    for (int m = 0; m < 257; ++m) nocc[m] = 0.0;
    for (int m = 1; m < 256; ++m) {
      const double o = occ[m];
      if (o != 0.0) {
        const int a = one[m];
        nocc[a] = __dadd_rn(nocc[a], __dmul_rn(o, p));
        const int b = 256 - one[256 - m];
        nocc[b] = __dadd_rn(nocc[b], __dmul_rn(o, q));
      }
    }
    double* s = occ;
    occ = nocc;
    nocc = s;
  }
  if constexpr (COUNT) atomicAdd(terms, n);
}

// best_state[i][k]: the first candidate j of i with the least len at k
template <int SPAN>
__global__ void __launch_bounds__(32) pick_kernel(
    const uint8_t* __restrict__ one_state, const double* __restrict__ lens,
    uint8_t* __restrict__ best_state) {
  const int idx = blockIdx.x * 32 + threadIdx.x;   // i * 256 + k
  const int i = idx >> 8, k = idx & 255;
  double best = (double)(1 << 30);
  int state = 0;
  for (int d = 0; d < SPAN; ++d) {
    const int row = i * SPAN + d;
    if (candidate<SPAN>(row, one_state) < 0) continue;
    const double v = lens[(size_t)row * 256 + k];
    if (v < best) {
      best = v;
      state = i - 10 + d;
    }
  }
  best_state[idx] = (uint8_t)state;
}

// Plain C entry point: one_state uint8 (256,), l2tab float64 (256,) (0 at
// 0, log2(m / 256) from the host's libm), lens float64 (256 * 21, 256)
// scratch, best_state uint8 (256, 256) out; terms uint64 (1,), zeroed,
// or null: where given, the fold's COUNT instance adds its terms there.
// Returns the cudaError_t of the launches (0 = ok).
extern "C" int find_best_state_launch(const void* one_state,
                                      const void* l2tab, void* lens,
                                      void* best_state, void* terms,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = 256 * sizeof(double) + 256;
  const int blocks = (256 * kSpan + 31) / 32;
  if (terms)
    fold_kernel<kSpan, true><<<blocks, 32, smem, s>>>(
        (const uint8_t*)one_state, (const double*)l2tab, (double*)lens,
        (unsigned long long*)terms);
  else
    fold_kernel<kSpan, false><<<blocks, 32, smem, s>>>(
        (const uint8_t*)one_state, (const double*)l2tab, (double*)lens,
        nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pick_kernel<kSpan><<<256 * 256 / 32, 32, 0, s>>>(
      (const uint8_t*)one_state, (const double*)lens, (uint8_t*)best_state);
  return (int)cudaGetLastError();
}
