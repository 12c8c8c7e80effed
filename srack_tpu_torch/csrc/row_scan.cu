// Row scans: kernel K4 of srack_tpu_torch (ops/scan_kernel.py).
//
// Replaces srack_tpu/ops/scan_kernel.py::_scan_rows, the Pallas kernel that
// streams [rows, n] arrays through VMEM in (32, 2048) tiles.  Inclusive
// scans along each row of a row-major [R, n] array, four kinds:
//
//   sum     f32, f64 or int32 (int32 adds wrap mod 2^32)
//   max     f32, f64 or int32
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
// Order of combination: row_scan.cuh, which holds the CTA scan (phases
// B-D) and which the Sample player's kernel K7 (sample_play.cu) includes,
// so that its prefix sums equal these bit for bit, as the JAX K7 copies the
// JAX K4's order.  In brief: each thread folds its elements left to right,
// the warp totals and then the warps' totals are scanned Hillis-Steele
// style, and out = carry e (warp prefix e (lane prefix e fold)).
//
// The fill combine of an earlier (v_a, ok_a) with a later (v_b, ok_b) is
// (ok_b ? v_b : v_a, ok_a | ok_b); the affine combine of an earlier (a_1,
// b_1) with a later (a_2, b_2) is (a_2 * a_1, a_2 * b_1 + b_2), as in the
// JAX package's _scan_block.  Built with --fmad=false: a*b+c rounds twice.
//
// The f64 entries (srk_scan_sum_f64, srk_scan_max_f64, srk_scan_fill_f64)
// are the same templates at V = double: exact precision's [V, n] f64 rows
// (the exact Oscillator block form's prefix sum of its increments and the
// fill of its Sync).  A double moves through the warp shuffle as two
// 32-bit words (srk_shfl_up), so the order of combination is the one
// above.  They read and write 8 bytes per element, twice the f32 sum's
// bytes, and stay bound by them: 7.9 GB at [1,024, 480,000], 2.3 ms at
// 3.35 TB/s.  The JAX package computes these scans in XLA (its K4 takes
// f32 and int32 only), so no Pallas kernel stands behind the f64 entries.
//
// The per-row body is written twice from one description: the kernel
// (shuffles, shared memory) and srk_scan_row_host, which runs the same
// phases over the same thread and lane indices with arrays, for the host
// build (g++) that the CPU tests check against the plain version.

#include "row_scan.cuh"

// -- the kinds: element type, identity, combine, load and store ----------

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
  srk_scan_fold<typename S::T, S>(loc);
}

#ifdef __CUDACC__

template <class S>
__global__ void __launch_bounds__(SRK_SCAN_THREADS)
    srk_scan_kernel(S s, int n) {
  typedef typename S::T T;
  __shared__ T warp_tot[SRK_SCAN_WARPS];
  __shared__ T carry_s;
  const size_t row = blockIdx.x;
  T carry = S::id();
  for (int base = 0; base < n; base += SRK_SCAN_CHUNK) {
    const int i0 = base + threadIdx.x * SRK_SCAN_ITEMS;
    T loc[SRK_SCAN_ITEMS];
    srk_scan_local(s, row, i0, n, loc);                       // A
    srk_cta_scan<T, S>(loc, carry, warp_tot, &carry_s);       // B-D
#pragma unroll
    for (int k = 0; k < SRK_SCAN_ITEMS; ++k)
      if (i0 + k < n) s.store(row, i0 + k, loc[k]);
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
  T carry = S::id();
  for (int base = 0; base < n; base += SRK_SCAN_CHUNK) {
    for (int tid = 0; tid < SRK_SCAN_THREADS; ++tid)          // A
      srk_scan_local(s, row, base + tid * SRK_SCAN_ITEMS, n, loc[tid]);
    srk_cta_scan_host<T, S>(loc, carry);                      // B-D
    for (int tid = 0; tid < SRK_SCAN_THREADS; ++tid)
      for (int k = 0; k < SRK_SCAN_ITEMS; ++k) {
        const int i = base + tid * SRK_SCAN_ITEMS + k;
        if (i < n) s.store(row, i, loc[tid][k]);
      }
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

extern "C" int srk_scan_sum_f64(const double* x, double* y, int rows,
                                int n SRK_STREAM) {
  SRK_SCAN_RUN((srk_scan1<double, srk_add>{x, y, n}), rows, n);
}

extern "C" int srk_scan_max_f32(const float* x, float* y, int rows,
                                int n SRK_STREAM) {
  SRK_SCAN_RUN((srk_scan1<float, srk_max>{x, y, n}), rows, n);
}

extern "C" int srk_scan_max_i32(const int* x, int* y, int rows,
                                int n SRK_STREAM) {
  SRK_SCAN_RUN((srk_scan1<int, srk_max>{x, y, n}), rows, n);
}

extern "C" int srk_scan_max_f64(const double* x, double* y, int rows,
                                int n SRK_STREAM) {
  SRK_SCAN_RUN((srk_scan1<double, srk_max>{x, y, n}), rows, n);
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

extern "C" int srk_scan_fill_f64(const double* vals, const int* mask,
                                 double* out_vals, int* out_ok, int k,
                                 int rows, int n SRK_STREAM) {
  switch (k) {
    SRK_FILL_CASE(double, 1)
    SRK_FILL_CASE(double, 2)
    SRK_FILL_CASE(double, 3)
    SRK_FILL_CASE(double, 4)
  }
  return -1;
}
