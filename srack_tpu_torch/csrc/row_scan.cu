// Row scans: kernel K4 of srack_tpu_torch (ops/scan_kernel.py).
//
// Replaces srack_tpu/ops/scan_kernel.py::_scan_rows, the Pallas kernel that
// streams [rows, n] arrays through VMEM in (32, 2048) tiles.  Inclusive
// scans along each row of a row-major [R, n] array, four kinds:
//
//   sum     f32 or int32 (int32 adds wrap mod 2^32)
//   max     f32 or int32
//   fill    "the last value where the mask held": K value rows (K <= 4, one
//           dtype) and one int32 mask; out values and an int32 "any valid"
//   affine  compose y -> a[t]*y + b[t]: (A, B) with y[t] = A[t]*y0 + B[t]
//
// Launch shape: one CTA of SRK_SCAN_THREADS threads per row, looping over
// the row's chunks of SRK_SCAN_CHUNK elements in order, the prefix of the
// chunks before carried in a register.  At [1,024, 480,000] that is 1,024
// CTAs, about eight per SM.  Bound: bytes.  Each element is read once and
// written once (8 bytes per element for a one-array f32 scan, 3.9 GB at
// [1,024, 480,000], 1.2 ms at 3.35 TB/s); the combine is a few operations
// per element.
//
// Order of combination.  The Sample player's kernel (K7, a later slice)
// must combine in this order so that its prefix sums equal these bit for
// bit, as the JAX K7 copies the JAX K4's order.  Write x_i for the
// elements of one chunk, e for the combine (a + b for sum, max, the fill
// and affine compositions below), carry for the value at the last element
// of the chunk before (the identity before the first chunk).
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
// The fill combine of an earlier (v_a, ok_a) with a later (v_b, ok_b) is
// (ok_b ? v_b : v_a, ok_a | ok_b); the affine combine of an earlier (a_1,
// b_1) with a later (a_2, b_2) is (a_2 * a_1, a_2 * b_1 + b_2), as in the
// JAX package's _scan_block.  Built with --fmad=false: a*b+c rounds twice.
//
// The per-row body is written twice from one description: the kernel
// (shuffles, shared memory) and srk_scan_row_host, which runs the same
// phases over the same thread and lane indices with arrays, for the host
// build (g++) that the CPU tests check against the plain version.

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

// -- the kinds: element type, identity, combine, load and store ----------

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
SRK_HD int srk_max<int>::id() { return INT32_MIN; }

// sum and max: one array in, one out
template <typename V, template <typename> class C>
struct srk_scan1 {
  typedef V T;
  const V* x;
  V* y;
  int n;
  SRK_HD static T id() { return C<V>::id(); }
  SRK_HD static T op(T a, T b) { return C<V>::op(a, b); }
  SRK_HD T load(size_t row, int i) const { return x[row * (size_t)n + i]; }
  SRK_HD void store(size_t row, int i, T v) const {
    y[row * (size_t)n + i] = v;
  }
};

template <typename V, int K>
struct srk_fill_t {
  V v[K];
  int ok;
};

// fill: K value arrays [K, R, n] and one mask [R, n] in; K value arrays
// and one "any valid" array out
template <typename V, int K>
struct srk_scan_fill {
  typedef srk_fill_t<V, K> T;
  const V* vals;
  const int* mask;
  V* out_vals;
  int* out_ok;
  int rows, n;
  SRK_HD static T id() {
    T t;
    for (int k = 0; k < K; ++k) t.v[k] = (V)0;
    t.ok = 0;
    return t;
  }
  SRK_HD static T op(T a, T b) {
    T t;
    for (int k = 0; k < K; ++k) t.v[k] = b.ok != 0 ? b.v[k] : a.v[k];
    t.ok = a.ok | b.ok;
    return t;
  }
  SRK_HD T load(size_t row, int i) const {
    T t;
    const size_t plane = (size_t)rows * (size_t)n;
    for (int k = 0; k < K; ++k) t.v[k] = vals[k * plane + row * n + i];
    t.ok = mask[row * (size_t)n + i];
    return t;
  }
  SRK_HD void store(size_t row, int i, T t) const {
    const size_t plane = (size_t)rows * (size_t)n;
    for (int k = 0; k < K; ++k) out_vals[k * plane + row * n + i] = t.v[k];
    out_ok[row * (size_t)n + i] = t.ok;
  }
};

struct srk_affine_t {
  float a, b;
};

// affine: A and B arrays in, composed A and B out
struct srk_scan_affine {
  typedef srk_affine_t T;
  const float* a;
  const float* b;
  float* out_a;
  float* out_b;
  int n;
  SRK_HD static T id() { return T{1.0f, 0.0f}; }
  SRK_HD static T op(T e, T l) { return T{l.a * e.a, l.a * e.b + l.b}; }
  SRK_HD T load(size_t row, int i) const {
    const size_t j = row * (size_t)n + i;
    return T{a[j], b[j]};
  }
  SRK_HD void store(size_t row, int i, T t) const {
    const size_t j = row * (size_t)n + i;
    out_a[j] = t.a;
    out_b[j] = t.b;
  }
};

// -- phase A, shared by both bodies ---------------------------------------

template <class S>
SRK_HD void srk_scan_local(const S& s, size_t row, int i0, int n,
                           typename S::T* loc) {
  for (int k = 0; k < SRK_SCAN_ITEMS; ++k)
    loc[k] = i0 + k < n ? s.load(row, i0 + k) : S::id();
  for (int k = 1; k < SRK_SCAN_ITEMS; ++k) loc[k] = S::op(loc[k - 1], loc[k]);
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

template <class T, class S>
__device__ __forceinline__ T srk_warp_scan(T v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T o = srk_shfl_up(v, d);
    if (lane >= d) v = S::op(o, v);
  }
  return v;
}

template <class S>
__global__ void __launch_bounds__(SRK_SCAN_THREADS)
    srk_scan_kernel(S s, int n) {
  typedef typename S::T T;
  __shared__ T warp_tot[SRK_SCAN_WARPS];
  __shared__ T carry_s;
  const size_t row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T carry = S::id();
  for (int base = 0; base < n; base += SRK_SCAN_CHUNK) {
    const int i0 = base + tid * SRK_SCAN_ITEMS;
    T loc[SRK_SCAN_ITEMS];
    srk_scan_local(s, row, i0, n, loc);                       // A
    const T tot = srk_warp_scan<T, S>(loc[SRK_SCAN_ITEMS - 1], lane);  // B
    T ex = srk_shfl_up(tot, 1);
    if (lane == 0) ex = S::id();
    if (lane == 31) warp_tot[warp] = tot;
    __syncthreads();
    if (warp == 0) {                                          // C
      T w = lane < SRK_SCAN_WARPS ? warp_tot[lane] : S::id();
      w = srk_warp_scan<T, S>(w, lane);
      if (lane < SRK_SCAN_WARPS) warp_tot[lane] = w;
    }
    __syncthreads();
    const T pw = warp == 0 ? S::id() : warp_tot[warp - 1];
#pragma unroll
    for (int k = 0; k < SRK_SCAN_ITEMS; ++k) {               // D
      const T v = S::op(carry, S::op(pw, S::op(ex, loc[k])));
      if (i0 + k < n) s.store(row, i0 + k, v);
      if (tid == SRK_SCAN_THREADS - 1 && k == SRK_SCAN_ITEMS - 1)
        carry_s = v;
    }
    __syncthreads();
    carry = carry_s;
  }
}

template <class S>
static int srk_scan_launch(const S& s, int rows, int n, void* stream) {
  if (rows > 0 && n > 0)
    srk_scan_kernel<S><<<rows, SRK_SCAN_THREADS, 0, (cudaStream_t)stream>>>(
        s, n);
  return (int)cudaGetLastError();
}

#define SRK_SCAN_RUN(s, rows, n) return srk_scan_launch(s, rows, n, stream)
#define SRK_STREAM , void* stream

#else  // the host build: the same phases over arrays

template <class S>
static void srk_scan_row_host(const S& s, size_t row, int n) {
  typedef typename S::T T;
  static T loc[SRK_SCAN_THREADS][SRK_SCAN_ITEMS];
  static T tot[SRK_SCAN_THREADS], ex[SRK_SCAN_THREADS];
  T carry = S::id();
  for (int base = 0; base < n; base += SRK_SCAN_CHUNK) {
    for (int tid = 0; tid < SRK_SCAN_THREADS; ++tid) {       // A
      srk_scan_local(s, row, base + tid * SRK_SCAN_ITEMS, n, loc[tid]);
      tot[tid] = loc[tid][SRK_SCAN_ITEMS - 1];
    }
    for (int w = 0; w < SRK_SCAN_WARPS; ++w) {               // B
      T* t = tot + 32 * w;
      for (int d = 1; d < 32; d <<= 1)
        for (int l = 31; l >= d; --l) t[l] = S::op(t[l - d], t[l]);
      ex[32 * w] = S::id();
      for (int l = 1; l < 32; ++l) ex[32 * w + l] = t[l - 1];
    }
    T wt[SRK_SCAN_WARPS];                                     // C
    for (int w = 0; w < SRK_SCAN_WARPS; ++w) wt[w] = tot[32 * w + 31];
    for (int d = 1; d < 32; d <<= 1)
      for (int l = SRK_SCAN_WARPS - 1; l >= d; --l)
        wt[l] = S::op(wt[l - d], wt[l]);
    T last = carry;
    for (int tid = 0; tid < SRK_SCAN_THREADS; ++tid) {       // D
      const int w = tid >> 5, i0 = base + tid * SRK_SCAN_ITEMS;
      const T pw = w == 0 ? S::id() : wt[w - 1];
      for (int k = 0; k < SRK_SCAN_ITEMS; ++k) {
        const T v = S::op(carry, S::op(pw, S::op(ex[tid], loc[tid][k])));
        if (i0 + k < n) s.store(row, i0 + k, v);
        last = v;
      }
    }
    carry = last;
  }
}

template <class S>
static int srk_scan_host(const S& s, int rows, int n) {
  for (int r = 0; r < rows; ++r) srk_scan_row_host(s, (size_t)r, n);
  return 0;
}

#define SRK_SCAN_RUN(s, rows, n) return srk_scan_host(s, rows, n)
#define SRK_STREAM

#endif

// -- entry points (the host build takes no stream) ------------------------

extern "C" int srk_scan_sum_f32(const float* x, float* y, int rows,
                                int n SRK_STREAM) {
  SRK_SCAN_RUN((srk_scan1<float, srk_add>{x, y, n}), rows, n);
}

extern "C" int srk_scan_sum_i32(const int* x, int* y, int rows,
                                int n SRK_STREAM) {
  SRK_SCAN_RUN((srk_scan1<int, srk_add>{x, y, n}), rows, n);
}

extern "C" int srk_scan_max_f32(const float* x, float* y, int rows,
                                int n SRK_STREAM) {
  SRK_SCAN_RUN((srk_scan1<float, srk_max>{x, y, n}), rows, n);
}

extern "C" int srk_scan_max_i32(const int* x, int* y, int rows,
                                int n SRK_STREAM) {
  SRK_SCAN_RUN((srk_scan1<int, srk_max>{x, y, n}), rows, n);
}

extern "C" int srk_scan_affine_f32(const float* a, const float* b,
                                   float* out_a, float* out_b, int rows,
                                   int n SRK_STREAM) {
  SRK_SCAN_RUN((srk_scan_affine{a, b, out_a, out_b, n}), rows, n);
}

#define SRK_FILL_CASE(V, K)                                                  \
  case K:                                                                    \
    SRK_SCAN_RUN((srk_scan_fill<V, K>{(const V*)vals, mask, (V*)out_vals,    \
                                      out_ok, rows, n}),                     \
                 rows, n);

extern "C" int srk_scan_fill_f32(const float* vals, const int* mask,
                                 float* out_vals, int* out_ok, int k,
                                 int rows, int n SRK_STREAM) {
  switch (k) {
    SRK_FILL_CASE(float, 1)
    SRK_FILL_CASE(float, 2)
    SRK_FILL_CASE(float, 3)
    SRK_FILL_CASE(float, 4)
  }
  return -1;
}

extern "C" int srk_scan_fill_i32(const int* vals, const int* mask,
                                 int* out_vals, int* out_ok, int k, int rows,
                                 int n SRK_STREAM) {
  switch (k) {
    SRK_FILL_CASE(int, 1)
    SRK_FILL_CASE(int, 2)
    SRK_FILL_CASE(int, 3)
    SRK_FILL_CASE(int, 4)
  }
  return -1;
}
