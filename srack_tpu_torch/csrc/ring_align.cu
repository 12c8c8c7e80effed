// Ring alignment: kernel K9 of srack_tpu_torch (ops/ring_roll.py).
//
// Replaces srack_tpu/ops/ring_roll.py::_align_rows, the Pallas kernel that
// left-rotates each row of [R, L] rings in VMEM (pltpu.roll of a doubled,
// 128-aligned copy).  Here every line of a Freeverb goes in one launch, and
// the move also changes the layout where the Freeverb kernel wants it:
//
//   dst_j[v, i] = src_j[v, (idx[j, v] + shift[j] + i) % L_j]
//
// for lines j = 0 .. n_lines-1 and voices v = 0 .. V-1.  Each line is a
// buffer of its own, laid out either as rings, [V, L_j] row-major (the
// module's state), or as lines, [L_j, V] (the Freeverb kernel's [rows, V],
// a warp's voices on neighbouring floats).  src and dst do not overlap.
// The Freeverb wrapper calls it twice per render: on entry rings -> lines
// with the per-voice write indices (every line then starts at index 0), on
// exit lines -> rings with shift[j] = n % L_j and no per-voice index (the
// rings back in the module's block convention: time order, index 0).
//
// Launch shape: a grid of (ceil(V / 32), ceil(max L / 256), n_lines) CTAs
// of 32 x 8 threads; threadIdx.x is the voice, threadIdx.y the position
// within the CTA's 256, stepping by 8.  In the lines layout a warp's 32
// voices touch 128 contiguous bytes; in the rings layout the 8 warps of a
// CTA read or write 8 neighbouring positions of the same 32 voices, so
// their 32-byte sectors are filled from L1 or merged in L2.  Bound: bytes,
// each element read once and written once: 2 x 108 MiB for the 24 lines
// of 1,024 voices at 48 kHz.  A pure move: exact.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SRK_HD __host__ __device__ __forceinline__
#else
#define SRK_HD inline
#endif

#define SRK_RING_MAX_LINES 32
#define SRK_RING_VOICES 32  // threadIdx.x
#define SRK_RING_ROWS 8     // threadIdx.y
#define SRK_RING_CHUNK 256  // positions per CTA

// the offset of (voice v, position i) in a line of length len
SRK_HD size_t srk_ring_at(int len, int V, int v, int i, int lines) {
  return lines ? (size_t)i * V + v : (size_t)v * len + i;
}

// voice v's rotation of line j: (idx[j, v] + shift) mod len, in [0, len)
SRK_HD int srk_ring_start(const int* idx, int shift, int j, int v, int V,
                          int len) {
  long long s = (long long)shift + (idx ? idx[(size_t)j * V + v] : 0);
  s %= len;
  return (int)(s < 0 ? s + len : s);
}

// one element: dst[v, i] = src[v, (s + i) % len]
SRK_HD void srk_ring_move(const float* src, float* dst, int len, int V,
                          int v, int i, int s, int src_lines,
                          int dst_lines) {
  int k = i + s;
  if (k >= len) k -= len;
  dst[srk_ring_at(len, V, v, i, dst_lines)] =
      src[srk_ring_at(len, V, v, k, src_lines)];
}

#ifdef __CUDACC__

struct SrkRingLines {
  const float* src[SRK_RING_MAX_LINES];
  float* dst[SRK_RING_MAX_LINES];
  int len[SRK_RING_MAX_LINES];
  int shift[SRK_RING_MAX_LINES];
};

__global__ void __launch_bounds__(SRK_RING_VOICES * SRK_RING_ROWS)
    srk_ring_align_kernel(SrkRingLines a, const int* __restrict__ idx, int V,
                          int src_lines, int dst_lines) {
  const int j = blockIdx.z, len = a.len[j];
  const int v = blockIdx.x * SRK_RING_VOICES + threadIdx.x;
  const int i0 = blockIdx.y * SRK_RING_CHUNK;
  if (v >= V || i0 >= len) return;
  const int s = srk_ring_start(idx, a.shift[j], j, v, V, len);
  const int i1 = min(i0 + SRK_RING_CHUNK, len);
  for (int i = i0 + threadIdx.y; i < i1; i += SRK_RING_ROWS)
    srk_ring_move(a.src[j], a.dst[j], len, V, v, i, s, src_lines, dst_lines);
}

// src, dst, lens, shifts: host arrays of n_lines entries; idx: [n_lines, V]
// int32 on the device, or NULL
extern "C" int srk_ring_align(const float* const* src, float* const* dst,
                              const int* lens, const int* shifts,
                              const int* idx, int n_lines, int V,
                              int src_lines, int dst_lines, void* stream) {
  if (n_lines < 0 || n_lines > SRK_RING_MAX_LINES)
    return (int)cudaErrorInvalidValue;
  SrkRingLines a;
  int max_len = 0;
  for (int j = 0; j < n_lines; ++j) {
    a.src[j] = src[j];
    a.dst[j] = dst[j];
    a.len[j] = lens[j];
    a.shift[j] = shifts[j];
    if (lens[j] > max_len) max_len = lens[j];
  }
  if (n_lines > 0 && V > 0 && max_len > 0) {
    const dim3 grid((V + SRK_RING_VOICES - 1) / SRK_RING_VOICES,
                    (max_len + SRK_RING_CHUNK - 1) / SRK_RING_CHUNK, n_lines);
    srk_ring_align_kernel<<<grid, dim3(SRK_RING_VOICES, SRK_RING_ROWS), 0,
                            (cudaStream_t)stream>>>(a, idx, V, src_lines,
                                                    dst_lines);
  }
  return (int)cudaGetLastError();
}

#else

extern "C" int srk_ring_align(const float* const* src, float* const* dst,
                              const int* lens, const int* shifts,
                              const int* idx, int n_lines, int V,
                              int src_lines, int dst_lines) {
  if (n_lines < 0 || n_lines > SRK_RING_MAX_LINES) return 1;
  for (int j = 0; j < n_lines; ++j)
    for (int v = 0; v < V; ++v) {
      const int s = srk_ring_start(idx, shifts[j], j, v, V, lens[j]);
      for (int i = 0; i < lens[j]; ++i)
        srk_ring_move(src[j], dst[j], lens[j], V, v, i, s, src_lines,
                      dst_lines);
    }
  return 0;
}

#endif
