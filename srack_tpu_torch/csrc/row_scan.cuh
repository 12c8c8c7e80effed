// The CTA scan of srack_tpu_torch's row-scan kernel K4 (row_scan.cu), shared
// with the Sample-player kernel K7 (sample_play.cu) so that both combine in
// one order and K7's prefix sums equal K4's bit for bit.
//
// Order of combination.  Write x_i for the elements of one chunk of
// SRK_SCAN_CHUNK elements, e for the combine, carry for the value at the
// last element of the chunk before (the identity before the first chunk).
//
//   A. thread i holds x[i*ITEMS .. i*ITEMS+ITEMS-1] and folds them left to
//      right: loc_k = (((x_0 e x_1) e x_2) ... e x_k);
//   B. the 32 thread totals of each warp are scanned Hillis-Steele style:
//      for d = 1, 2, 4, 8, 16, lane l >= d sets T_l = T_{l-d} e T_l; the
//      lane's exclusive prefix is E_l = T_{l-1} (E_0 = identity);
//   C. the warp totals (lane 31's T) are scanned the same way by warp 0;
//      the warp's exclusive prefix is P_w = W_{w-1} (P_0 = identity);
//   D. out_k = carry e (P_w e (E_l e loc_k)), and the next chunk's carry is
//      the out value of this chunk's last element.
//
// Past the end of the row the elements are the identity.  Combining with
// the identity is exact for every kind, so a short row or a partial chunk
// takes the same order as its elements' positions give.
//
// Phase A is the caller's (it loads its own elements); srk_cta_scan2 (K4's
// kernel) runs B to D on the CTA, srk_cta_scan_host the same phases over
// arrays for the host build (g++), which the CPU tests check against the
// plain versions.  srk_cta_scan2 takes two barriers a chunk: the warp
// totals and the carry sit in double-buffered shared slots indexed by the
// chunk's parity, so chunk c's carry is read in phase D of chunk c + 1,
// after that chunk's barriers, and nothing is broadcast at the end of a
// chunk.  K7's tile kernel (sample_play.cu) runs the same phases with
// srk_warp_scan and srk_shfl_up over the same positions.

#ifndef SRK_ROW_SCAN_CUH
#define SRK_ROW_SCAN_CUH

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SRK_HD __host__ __device__ __forceinline__
#else
#define SRK_HD inline
#endif

#define SRK_SCAN_THREADS 256
#define SRK_SCAN_ITEMS 4
#define SRK_SCAN_WARPS (SRK_SCAN_THREADS / 32)
#define SRK_SCAN_CHUNK (SRK_SCAN_THREADS * SRK_SCAN_ITEMS)

// -- combines: identity and operation ---------------------------------------

template <typename V>
struct srk_add {
  SRK_HD static V id() { return (V)0; }
  SRK_HD static V op(V a, V b) { return a + b; }
};

template <>
struct srk_add<int> {
  SRK_HD static int id() { return 0; }
  SRK_HD static int op(int a, int b) {
    return (int)((uint32_t)a + (uint32_t)b);  // wraps mod 2^32
  }
};

template <typename V>
struct srk_max {
  SRK_HD static V id();
  // a NaN propagates, as torch.maximum's does
  SRK_HD static V op(V a, V b) { return (b > a || b != b) ? b : a; }
};

template <>
SRK_HD float srk_max<float>::id() { return -INFINITY; }
template <>
SRK_HD double srk_max<double>::id() { return -INFINITY; }
template <>
SRK_HD int srk_max<int>::id() { return INT32_MIN; }

// phase A over loaded elements: loc[k] = loc[0] e ... e loc[k]
template <class T, class C>
SRK_HD void srk_scan_fold(T* loc) {
  for (int k = 1; k < SRK_SCAN_ITEMS; ++k) loc[k] = C::op(loc[k - 1], loc[k]);
}

#ifdef __CUDACC__

template <class T>
__device__ __forceinline__ T srk_shfl_up(T v, int d) {
  static_assert(sizeof(T) % 4 == 0, "shuffled in 32-bit words");
  int w[sizeof(T) / 4];
  memcpy(w, &v, sizeof(T));
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 4); ++i)
    w[i] = __shfl_up_sync(0xffffffffu, w[i], d);
  memcpy(&v, w, sizeof(T));
  return v;
}

template <class T, class C>
__device__ __forceinline__ T srk_warp_scan(T v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T o = srk_shfl_up(v, d);
    if (lane >= d) v = C::op(o, v);
  }
  return v;
}

// Phases B-D for chunk ``c`` with two barriers: ``warp_tot`` is
// [2][SRK_SCAN_WARPS] and ``carry_s`` [2] in shared memory; the carry is
// carry_s[(c + 1) & 1], chunk c - 1's last value (thread 255 stores
// carry_s[1] = identity before chunk 0), and chunk c's goes to
// carry_s[c & 1].  A slot of parity c & 1 is written again only in chunk
// c + 2, after every thread has passed chunk c + 1's barriers and so left
// chunk c's phase D.  The combines are those of the order above.
template <class T, class C>
__device__ __forceinline__ void srk_cta_scan2(T* loc, int c,
                                              T (*warp_tot)[SRK_SCAN_WARPS],
                                              T* carry_s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* wt = warp_tot[c & 1];
  const T tot = srk_warp_scan<T, C>(loc[SRK_SCAN_ITEMS - 1], lane);  // B
  T ex = srk_shfl_up(tot, 1);
  if (lane == 0) ex = C::id();
  if (lane == 31) wt[warp] = tot;
  __syncthreads();
  if (warp == 0) {                                                  // C
    T w = lane < SRK_SCAN_WARPS ? wt[lane] : C::id();
    w = srk_warp_scan<T, C>(w, lane);
    if (lane < SRK_SCAN_WARPS) wt[lane] = w;
  }
  __syncthreads();
  const T pw = warp == 0 ? C::id() : wt[warp - 1];
  const T carry = carry_s[(c + 1) & 1];
#pragma unroll
  for (int k = 0; k < SRK_SCAN_ITEMS; ++k)                          // D
    loc[k] = C::op(carry, C::op(pw, C::op(ex, loc[k])));
  if (tid == SRK_SCAN_THREADS - 1) carry_s[c & 1] = loc[SRK_SCAN_ITEMS - 1];
}

#else  // the host build: the same phases over arrays

// Phases B-D for one chunk: ``loc[tid]`` holds thread tid's phase-A values
// and gets the chunk's inclusive scan; ``carry`` moves to its last value.
template <class T, class C>
static void srk_cta_scan_host(T (*loc)[SRK_SCAN_ITEMS], T& carry) {
  T tot[SRK_SCAN_THREADS], ex[SRK_SCAN_THREADS], wt[SRK_SCAN_WARPS];
  for (int tid = 0; tid < SRK_SCAN_THREADS; ++tid)
    tot[tid] = loc[tid][SRK_SCAN_ITEMS - 1];
  for (int w = 0; w < SRK_SCAN_WARPS; ++w) {                       // B
    T* t = tot + 32 * w;
    for (int d = 1; d < 32; d <<= 1)
      for (int l = 31; l >= d; --l) t[l] = C::op(t[l - d], t[l]);
    ex[32 * w] = C::id();
    for (int l = 1; l < 32; ++l) ex[32 * w + l] = t[l - 1];
  }
  for (int w = 0; w < SRK_SCAN_WARPS; ++w) wt[w] = tot[32 * w + 31];  // C
  for (int d = 1; d < 32; d <<= 1)
    for (int l = SRK_SCAN_WARPS - 1; l >= d; --l)
      wt[l] = C::op(wt[l - d], wt[l]);
  T last = carry;
  for (int tid = 0; tid < SRK_SCAN_THREADS; ++tid) {               // D
    const T pw = (tid >> 5) == 0 ? C::id() : wt[(tid >> 5) - 1];
    for (int k = 0; k < SRK_SCAN_ITEMS; ++k) {
      loc[tid][k] = C::op(carry, C::op(pw, C::op(ex[tid], loc[tid][k])));
      last = loc[tid][k];
    }
  }
  carry = last;
}

// srk_cta_scan2's slots over srk_cta_scan_host's phases: the carry from
// carry_s[(c + 1) & 1], chunk c's last value into carry_s[c & 1].
template <class T, class C>
static void srk_cta_scan2_host(T (*loc)[SRK_SCAN_ITEMS], int c, T* carry_s) {
  T carry = carry_s[(c + 1) & 1];
  srk_cta_scan_host<T, C>(loc, carry);
  carry_s[c & 1] = carry;
}

#endif

#endif  // SRK_ROW_SCAN_CUH
