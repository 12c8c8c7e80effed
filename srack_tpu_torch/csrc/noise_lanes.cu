// Noise lanes: the Noise module's draw in srack_tpu_torch
// (ops/noise_kernel.py).
//
// Ports no Pallas kernel: the JAX package draws its Noise lanes with
// jax.random.uniform (threefry, in XLA) in
// srack_tpu/modules/oscillator.py::_noise_make_xs.  The port draws its own
// bits, a counter-based generator in the manner of Philox: a keyed
// bijection of the sample counter.  For row r (one voice of one Noise
// module) with the 64-bit key k = k1 * 2^32 + k0, and sample t < 2^31,
//
//   w = L(L(L(t ^ k0) ^ k1) ^ k0),   out[r, t] = (w >> 8) * 2^-23 - 1,
//
// uniform in [-1, 1) on a grid of 2^-23.  L is lowbias32 (x ^= x >> 16;
// x *= 0x7feb352d; x ^= x >> 15; x *= 0x846ca68b; x ^= x >> 16), a
// bijection of 32-bit words.  So for one key t -> w is a bijection: a lane
// never repeats a word.  The key enters every round, not as an offset of
// the counter: two lanes are the same lane, shifted or permuted, only
// where their whole 64-bit keys are equal (ops/noise_kernel.py keys each
// voice by fold_in, 64 bits).  A counter added to a 32-bit key would put
// every lane on one cycle of 2^32 words, and lanes of a large batch would
// overlap as shifted copies.
//
// Bound: bytes on the card, the [R, n] f32 output written once and the R
// keys read once: 1.97 GB for the drums render's 1,024 voices x 480,000
// samples, 0.59 ms at 3.35 TB/s.  About 30 integer operations an element
// (three rounds of 8, the key words, the conversion) come close: a pass
// that only computes and writes.  One CTA of 256 threads per (1,024
// samples of one row); each thread writes 4 samples 256 apart, so a warp
// store covers 128 contiguous bytes; the grid's second dimension walks the
// rows (at most 65,535 CTAs, then a loop).  Integer arithmetic and one
// exact conversion: the host build and the plain version
// (ops/noise_kernel.py::noise_lanes_plain) give the same bits.
//
// The host build (g++, for the tests) runs the same element function in a
// loop over rows and samples.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SRK_HD __host__ __device__ __forceinline__
#else
#define SRK_HD inline
#endif

#define SRK_NOISE_THREADS 256
#define SRK_NOISE_ITEMS 4       // samples per thread, SRK_NOISE_THREADS apart
#define SRK_NOISE_GRID_ROWS 65535

SRK_HD uint32_t srk_lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

SRK_HD float srk_noise_value(uint64_t key, uint32_t t) {
  const uint32_t k0 = (uint32_t)key, k1 = (uint32_t)(key >> 32);
  const uint32_t w =
      srk_lowbias32(srk_lowbias32(srk_lowbias32(t ^ k0) ^ k1) ^ k0);
  return (float)(w >> 8) * 0x1p-23f - 1.0f;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(SRK_NOISE_THREADS)
    srk_noise_kernel(const uint64_t* __restrict__ keys,
                     float* __restrict__ out, long long rows, int n) {
  const int t0 =
      blockIdx.x * (SRK_NOISE_THREADS * SRK_NOISE_ITEMS) + threadIdx.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint64_t key = keys[r];
    float* row = out + (size_t)r * n;
#pragma unroll
    for (int k = 0; k < SRK_NOISE_ITEMS; ++k) {
      const int t = t0 + k * SRK_NOISE_THREADS;
      if (t < n) row[t] = srk_noise_value(key, (uint32_t)t);
    }
  }
}

// -- entry point (the host build takes no stream) ---------------------------

extern "C" int srk_noise_lanes(const uint64_t* keys, float* out,
                               long long rows, int n, void* stream) {
  if (rows > 0 && n > 0) {
    const int per = SRK_NOISE_THREADS * SRK_NOISE_ITEMS;
    const dim3 grid((unsigned)((n + per - 1) / per),
                    (unsigned)(rows < SRK_NOISE_GRID_ROWS
                                   ? rows : SRK_NOISE_GRID_ROWS));
    srk_noise_kernel<<<grid, SRK_NOISE_THREADS, 0, (cudaStream_t)stream>>>(
        keys, out, rows, n);
  }
  return (int)cudaGetLastError();
}

#else  // the host build

extern "C" int srk_noise_lanes(const uint64_t* keys, float* out,
                               long long rows, int n) {
  for (long long r = 0; r < rows; ++r)
    for (int t = 0; t < n; ++t)
      out[(size_t)r * n + t] = srk_noise_value(keys[r], (uint32_t)t);
  return 0;
}

#endif
