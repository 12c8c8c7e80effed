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
// Bound: bytes, each element read once and written once: 2 x 108 MiB for
// the 24 lines of 1,024 voices at 48 kHz, 0.068 ms at 3.35 TB/s.  A pure
// move: exact.
//
// The entry, srk_ring_align_tile (its tile length P chosen by the
// wrapper), is a rotated transpose through a shared-memory tile.  One CTA
// of 8 warps per (tile of P destination positions of one line, 32 voices);
// the tiles of all lines are numbered in one grid dimension (line j's
// first tile at tile0[j]), so no CTA idles on a short line.  For voice v
// the tile's source positions are one run, (s_v + i0) .. (s_v + i0 + P -
// 1) mod L_j, which wraps at most once.  So each side is walked the way it
// lies: a [V, L_j] ring by warps that walk one voice's positions (128
// contiguous bytes a warp access, the rotation folded into the run's
// start), an [L_j, V] line by warps that walk voices (128 contiguous bytes
// at one position).  The tile sits in shared memory as [32][P + 1] floats:
// the padding puts both passes' 32 lanes on 32 banks.  One __syncthreads
// between the pass in and the pass out.  The lines side of the exit call
// rotates by a per-line shift, the same for every voice, so its reads stay
// on one row; a lines source with per-voice indices (no call of the
// wrapper) would scatter them.  On an NVIDIA H100 80GB HBM3 at 700 W the
// 24 lines of 1,024 voices at 48 kHz take about 0.095 ms a call in either
// direction, 70 % of the bound, at P = 128 (P = 256 is as fast, 32 and 64
// slower; chip_smoke.py phase 15 times each).  One thread per voice and
// position, a warp's 32 lanes on 32 rings L_j floats apart, took about
// 0.13 ms rings -> lines and 0.61 ms lines -> rings at the same shapes.
//
// The f64 entry (srk_ring_align_tile_f64) is the same template at T =
// double, for exact precision's f64 Freeverb lines: [V, L] rings of
// doubles.  Moving the doubles as pairs of 32-bit words would not do: on
// the [L, V] side a pair would interleave two voices' words.  The tile is
// [32][P + 1] doubles (33 KB at P = 128); the padding still keeps both
// passes off bank conflicts (a half-warp's 16 doubles a row apart start 2 *
// 129 words apart: 16 distinct bank pairs).  Twice the bytes of the f32
// build, the same bound by bytes; exact.
//
// The host build (g++, for the tests) runs the same tile passes, thread by
// thread over a host tile.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SRK_HD __host__ __device__ __forceinline__
#else
#include <vector>
#define SRK_HD inline
#endif

#define SRK_RING_MAX_LINES 32
#define SRK_RING_VOICES 32  // voices per tile
#define SRK_RING_ROWS 8     // warps per tile
#define SRK_RING_TILE_MIN 32
#define SRK_RING_TILE_MAX 256

// voice v's rotation of line j: (idx[j, v] + shift) mod len, in [0, len)
SRK_HD int srk_ring_start(const int* idx, int shift, int j, int v, int V,
                          int len) {
  long long s = (long long)shift + (idx ? idx[(size_t)j * V + v] : 0);
  s %= len;
  return (int)(s < 0 ? s + len : s);
}

template <typename T>
struct SrkRingLines {
  const T* src[SRK_RING_MAX_LINES];
  T* dst[SRK_RING_MAX_LINES];
  int len[SRK_RING_MAX_LINES];
  int shift[SRK_RING_MAX_LINES];
  int tile0[SRK_RING_MAX_LINES + 1];  // line j: tiles tile0[j] .. tile0[j+1]
};

// -- the tile: one CTA's part, written per thread ------------------------

struct SrkRingTile {
  int j, len, i0, cnt;   // line, its length, first position, positions
  int v0, nv;            // first voice, voices
};

// tile b of voice group y (blockIdx.x, blockIdx.y on the card)
template <typename T>
SRK_HD SrkRingTile srk_ring_tile(const SrkRingLines<T>& a, int n_lines,
                                 int b, int y, int V, int P) {
  SrkRingTile t;
  t.j = 0;
  while (t.j + 1 < n_lines && a.tile0[t.j + 1] <= b) ++t.j;
  t.len = a.len[t.j];
  t.i0 = (b - a.tile0[t.j]) * P;
  t.cnt = t.len - t.i0 < P ? t.len - t.i0 : P;
  t.v0 = y * SRK_RING_VOICES;
  t.nv = V - t.v0 < SRK_RING_VOICES ? V - t.v0 : SRK_RING_VOICES;
  return t;
}

// thread (warp, lane)'s part of the pass in: tile[u][p] = src[v0 + u,
// (s_u + i0 + p) % len] for the tile's voices u and positions p
template <typename T>
SRK_HD void srk_ring_tile_in(const SrkRingLines<T>& a, const int* idx,
                             const SrkRingTile& t, T* tile, int P, int V,
                             int lines, int warp, int lane) {
  const T* src = a.src[t.j];
  const int shift = a.shift[t.j], w = P + 1;
  if (lines) {   // a warp walks voices at one position: lane = voice
    if (lane >= t.nv) return;
    const int v = t.v0 + lane;
    int k = srk_ring_start(idx, shift, t.j, v, V, t.len) + t.i0 + warp;
    if (k >= t.len) k -= t.len;
#pragma unroll 4
    for (int p = warp; p < t.cnt; p += SRK_RING_ROWS) {
      tile[lane * w + p] = src[(size_t)k * V + v];
      k += SRK_RING_ROWS;
      if (k >= t.len) k -= t.len;
    }
  } else {       // a warp walks one voice's run: lane = position
    for (int u = warp; u < t.nv; u += SRK_RING_ROWS) {
      const int v = t.v0 + u;
      const T* row = src + (size_t)v * t.len;
      int k = srk_ring_start(idx, shift, t.j, v, V, t.len) + t.i0 + lane;
      if (k >= t.len) k -= t.len;
#pragma unroll 4
      for (int p = lane; p < t.cnt; p += 32) {
        tile[u * w + p] = row[k];
        k += 32;
        if (k >= t.len) k -= t.len;
      }
    }
  }
}

// thread (warp, lane)'s part of the pass out: dst[v0 + u, i0 + p] =
// tile[u][p]
template <typename T>
SRK_HD void srk_ring_tile_out(const SrkRingLines<T>& a, const SrkRingTile& t,
                              const T* tile, int P, int V, int lines,
                              int warp, int lane) {
  T* dst = a.dst[t.j];
  const int w = P + 1;
  if (lines) {
    if (lane >= t.nv) return;
    const int v = t.v0 + lane;
#pragma unroll 4
    for (int p = warp; p < t.cnt; p += SRK_RING_ROWS)
      dst[(size_t)(t.i0 + p) * V + v] = tile[lane * w + p];
  } else {
    for (int u = warp; u < t.nv; u += SRK_RING_ROWS) {
      T* row = dst + (size_t)(t.v0 + u) * t.len + t.i0;
#pragma unroll 4
      for (int p = lane; p < t.cnt; p += 32) row[p] = tile[u * w + p];
    }
  }
}

// the lines' table and the number of tiles of P positions; -1 if the
// arguments are out of range
template <typename T>
static int srk_ring_lines(SrkRingLines<T>* a, const T* const* src,
                          T* const* dst, const int* lens, const int* shifts,
                          int n_lines, int P) {
  if (n_lines < 0 || n_lines > SRK_RING_MAX_LINES || P < SRK_RING_TILE_MIN
      || P > SRK_RING_TILE_MAX || P % 32)
    return -1;
  int tiles = 0;
  for (int j = 0; j < n_lines; ++j) {
    a->src[j] = src[j];
    a->dst[j] = dst[j];
    a->len[j] = lens[j];
    a->shift[j] = shifts[j];
    a->tile0[j] = tiles;
    tiles += (lens[j] + P - 1) / P;
  }
  a->tile0[n_lines] = tiles;
  return tiles;
}

#ifdef __CUDACC__

// the table stays in the parameter space (__grid_constant__): the passes
// index it by line and take it by reference without a local copy
template <typename T>
__global__ void __launch_bounds__(SRK_RING_VOICES * SRK_RING_ROWS)
    srk_ring_tile_kernel(const __grid_constant__ SrkRingLines<T> a,
                         const int* __restrict__ idx,
                         int n_lines, int V, int src_lines, int dst_lines,
                         int P) {
  extern __shared__ __align__(16) unsigned char srk_ring_smem[];
  T* tile = reinterpret_cast<T*>(srk_ring_smem);   // [32][P + 1]
  const SrkRingTile t = srk_ring_tile(a, n_lines, blockIdx.x, blockIdx.y,
                                      V, P);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  srk_ring_tile_in(a, idx, t, tile, P, V, src_lines, warp, lane);
  __syncthreads();
  srk_ring_tile_out(a, t, tile, P, V, dst_lines, warp, lane);
}

template <typename T>
static int srk_ring_align_tile_run(const T* const* src, T* const* dst,
                                   const int* lens, const int* shifts,
                                   const int* idx, int n_lines, int V,
                                   int src_lines, int dst_lines, int P,
                                   void* stream) {
  SrkRingLines<T> a;
  const int tiles = srk_ring_lines(&a, src, dst, lens, shifts, n_lines, P);
  if (tiles < 0) return (int)cudaErrorInvalidValue;
  if (tiles > 0 && V > 0) {
    const dim3 grid(tiles, (V + SRK_RING_VOICES - 1) / SRK_RING_VOICES);
    const size_t bytes = sizeof(T) * SRK_RING_VOICES * (P + 1);
    srk_ring_tile_kernel<T><<<grid, SRK_RING_VOICES * SRK_RING_ROWS, bytes,
                              (cudaStream_t)stream>>>(
        a, idx, n_lines, V, src_lines, dst_lines, P);
  }
  return (int)cudaGetLastError();
}

// src, dst, lens, shifts: host arrays of n_lines entries; idx: [n_lines, V]
// int32 on the device, or NULL; P: positions per tile (32 .. 256, a
// multiple of 32)
extern "C" int srk_ring_align_tile(const float* const* src, float* const* dst,
                                   const int* lens, const int* shifts,
                                   const int* idx, int n_lines, int V,
                                   int src_lines, int dst_lines, int P,
                                   void* stream) {
  return srk_ring_align_tile_run<float>(src, dst, lens, shifts, idx, n_lines,
                                        V, src_lines, dst_lines, P, stream);
}

extern "C" int srk_ring_align_tile_f64(const double* const* src,
                                       double* const* dst, const int* lens,
                                       const int* shifts, const int* idx,
                                       int n_lines, int V, int src_lines,
                                       int dst_lines, int P, void* stream) {
  return srk_ring_align_tile_run<double>(src, dst, lens, shifts, idx,
                                         n_lines, V, src_lines, dst_lines, P,
                                         stream);
}

#else

template <typename T>
static int srk_ring_align_tile_run(const T* const* src, T* const* dst,
                                   const int* lens, const int* shifts,
                                   const int* idx, int n_lines, int V,
                                   int src_lines, int dst_lines, int P) {
  SrkRingLines<T> a;
  const int tiles = srk_ring_lines(&a, src, dst, lens, shifts, n_lines, P);
  if (tiles < 0) return 1;
  std::vector<T> tile((size_t)SRK_RING_VOICES * (P + 1));
  for (int y = 0; y < (V + SRK_RING_VOICES - 1) / SRK_RING_VOICES; ++y)
    for (int b = 0; b < tiles; ++b) {
      const SrkRingTile t = srk_ring_tile(a, n_lines, b, y, V, P);
      for (int warp = 0; warp < SRK_RING_ROWS; ++warp)
        for (int lane = 0; lane < 32; ++lane)
          srk_ring_tile_in(a, idx, t, tile.data(), P, V, src_lines, warp,
                           lane);
      for (int warp = 0; warp < SRK_RING_ROWS; ++warp)
        for (int lane = 0; lane < 32; ++lane)
          srk_ring_tile_out(a, t, tile.data(), P, V, dst_lines, warp, lane);
    }
  return 0;
}

extern "C" int srk_ring_align_tile(const float* const* src, float* const* dst,
                                   const int* lens, const int* shifts,
                                   const int* idx, int n_lines, int V,
                                   int src_lines, int dst_lines, int P) {
  return srk_ring_align_tile_run<float>(src, dst, lens, shifts, idx, n_lines,
                                        V, src_lines, dst_lines, P);
}

extern "C" int srk_ring_align_tile_f64(const double* const* src,
                                       double* const* dst, const int* lens,
                                       const int* shifts, const int* idx,
                                       int n_lines, int V, int src_lines,
                                       int dst_lines, int P) {
  return srk_ring_align_tile_run<double>(src, dst, lens, shifts, idx,
                                         n_lines, V, src_lines, dst_lines, P);
}

#endif
