// Row gathers: kernels K5 and K6 of srack_tpu_torch (ops/gather_kernel.py).
//
// out[r, t] = table[r, j] for int32 idx [R, n] and f32 or int32 tables
// [R, K], row-major, with j the JAX package's select-tree index
// min(idx & (P - 1), K - 1), P the next power of two >= K: for an index in
// [0, K) plainly the entry there; for any other the low bits' entry, as
// the tree pads the table to P with its last entry.  j is computed here, so
// the wrapper makes no extra [R, n] pass.
//
// Replaces two TPU kernels that compute the same function:
//
//   K5  srack_tpu/ops/scan_kernel.py::_gather_rows, an in-VMEM select
//       chain for tables of K <= 1,024 (GATHER_MAX_K): the sequencers'
//       whole-block step lookups.  Entry "small" (srk_gather_small_*): a
//       CTA stages its row's table in shared memory (<= 4 KiB) and reads it
//       from there.
//   K6  srack_tpu/ops/sample_gather.py::_gather_rows / _gather_precomputed,
//       the same gather for long tables (the Sample player's reads), built
//       of window, slab and residual tiers around tpu.dynamic_gather.  Entry
//       "long" (srk_gather_long_*): the same launch shape, the table read
//       through L1/L2 (__ldg).  Sample positions within a tile are mostly
//       consecutive, so neighbouring threads read neighbouring words.
//
// None of the TPU tiers carries over: on the GPU a read from a row's table
// is one load.  (JAX's K5 answers table[0] for an index at or past K, its
// chain starting from entry 0; both entries here follow the select tree,
// as the JAX package's step and its block form off the TPU do.)
//
// Launch shape: one CTA of SRK_GATHER_THREADS threads per (row, tile of
// SRK_GATHER_TILE indices), blockIdx.x = row * tiles + tile; idx loads and
// out stores coalesced.  Bound: bytes.  Each index is read and each output
// written once, 8 bytes per element (3.93 GB at [1,024, 480,000], 1.17 ms
// at 3.35 TB/s), plus the table once (small: per CTA from L2).
//
// The host build (g++) runs the same per-element body in a loop, for the
// CPU tests.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SRK_HD __host__ __device__ __forceinline__
#else
#define SRK_HD inline
#endif

#define SRK_GATHER_THREADS 256
#define SRK_GATHER_TILE 2048
#define SRK_GATHER_MAX_K 1024

// the select tree's index: mask = P - 1
SRK_HD int srk_gather_index(int idx, int k, int mask) {
  const int j = idx & mask;
  return j < k - 1 ? j : k - 1;
}

static int srk_gather_mask(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p - 1;
}

#ifdef __CUDACC__

template <typename V, bool SMALL>
__global__ void __launch_bounds__(SRK_GATHER_THREADS)
    srk_gather_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                      V* __restrict__ out, int k, int mask, int n,
                      int tiles) {
  __shared__ V tbl_s[SMALL ? SRK_GATHER_MAX_K : 1];
  const size_t row = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * SRK_GATHER_TILE;
  const V* trow = table + row * (size_t)k;
  if (SMALL) {
    for (int j = threadIdx.x; j < k; j += SRK_GATHER_THREADS)
      tbl_s[j] = trow[j];
    __syncthreads();
  }
  const int t1 = min(t0 + SRK_GATHER_TILE, n);
  for (int t = t0 + threadIdx.x; t < t1; t += SRK_GATHER_THREADS) {
    const size_t o = row * (size_t)n + t;
    const int j = srk_gather_index(idx[o], k, mask);
    out[o] = SMALL ? tbl_s[j] : __ldg(trow + j);
  }
}

template <typename V, bool SMALL>
static int srk_gather(const V* table, const int* idx, V* out, int rows,
                      int k, int n, void* stream) {
  if (SMALL && k > SRK_GATHER_MAX_K) return -1;
  if (rows > 0 && n > 0 && k > 0) {
    const int tiles = (n + SRK_GATHER_TILE - 1) / SRK_GATHER_TILE;
    srk_gather_kernel<V, SMALL>
        <<<(unsigned)((size_t)rows * tiles), SRK_GATHER_THREADS, 0,
           (cudaStream_t)stream>>>(table, idx, out, k, srk_gather_mask(k), n,
                                   tiles);
  }
  return (int)cudaGetLastError();
}

#define SRK_STREAM , void* stream
#define SRK_STREAM_ARG stream

#else  // the host build

template <typename V, bool SMALL>
static int srk_gather(const V* table, const int* idx, V* out, int rows,
                      int k, int n, void*) {
  if (SMALL && k > SRK_GATHER_MAX_K) return -1;
  if (k <= 0) return 0;
  const int mask = srk_gather_mask(k);
  for (size_t r = 0; r < (size_t)rows; ++r)
    for (int t = 0; t < n; ++t) {
      const size_t o = r * (size_t)n + t;
      out[o] = table[r * (size_t)k + srk_gather_index(idx[o], k, mask)];
    }
  return 0;
}

#define SRK_STREAM
#define SRK_STREAM_ARG nullptr

#endif

// -- entry points (the host build takes no stream) --------------------------

extern "C" int srk_gather_small_f32(const float* table, const int* idx,
                                    float* out, int rows, int k,
                                    int n SRK_STREAM) {
  return srk_gather<float, true>(table, idx, out, rows, k, n, SRK_STREAM_ARG);
}

extern "C" int srk_gather_small_i32(const int* table, const int* idx,
                                    int* out, int rows, int k,
                                    int n SRK_STREAM) {
  return srk_gather<int, true>(table, idx, out, rows, k, n, SRK_STREAM_ARG);
}

extern "C" int srk_gather_long_f32(const float* table, const int* idx,
                                   float* out, int rows, int k,
                                   int n SRK_STREAM) {
  return srk_gather<float, false>(table, idx, out, rows, k, n,
                                  SRK_STREAM_ARG);
}

extern "C" int srk_gather_long_i32(const int* table, const int* idx,
                                   int* out, int rows, int k,
                                   int n SRK_STREAM) {
  return srk_gather<int, false>(table, idx, out, rows, k, n, SRK_STREAM_ARG);
}
