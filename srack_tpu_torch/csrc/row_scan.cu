// Row scans: kernel K4 of srack_tpu_torch (ops/scan_kernel.py).
//
// Replaces srack_tpu/ops/scan_kernel.py::_scan_rows (:138, its pallas_call
// at :172), the Pallas kernel that streams [rows, n] arrays through VMEM in
// (32, 2048) tiles.  Inclusive scans along each row of a row-major [R, n]
// array, four kinds:
//
//   sum     f32, f64 or int32 (int32 adds wrap mod 2^32)
//   max     f32, f64 or int32
//   fill    "the last value where the mask held": K value rows (K <= 4, one
//           dtype) and one int32 mask; out values and an int32 "any valid"
//   affine  compose y -> a[t]*y + b[t]: (A, B) with y[t] = A[t]*y0 + B[t]
//
// The f64 entries (srk_scan_{sum,max,fill}_f64) take exact precision's
// [V, n] f64 rows (the exact Oscillator block form's prefix sum of its
// increments and the fill of its Sync).  The JAX package computes those in
// XLA (its K4 takes f32 and int32 only), so they replace no Pallas kernel.
//
// Bound: bytes.  Each element is read once and written once, and the
// combine is a few operations an element: 8 bytes an element for an f32 or
// int32 sum or max (3.9 GB at [1,024, 480,000], 1.17 ms at 3.35 TB/s), 16
// for an f64 sum or max or an affine scan, (2K + 2) x the element size for
// a fill of K arrays (its int32 mask and "any valid" included).
//
// Order of combination: row_scan.cuh, which holds the CTA scan (phases
// B-D) and which the Sample player's kernel K7 (sample_play.cu) includes,
// so that its prefix sums equal these bit for bit, as the JAX K7 copies the
// JAX K4's order.  In brief: each thread folds its 4 consecutive elements
// left to right, the warp totals and then the warps' totals are scanned
// Hillis-Steele style, and out = carry e (warp prefix e (lane prefix e
// fold)), chunk by chunk of 1,024 elements, the carry the previous
// chunk's last output.  The fill combine of an earlier (v_a, ok_a) with a
// later (v_b, ok_b) is (ok_b ? v_b : v_a, ok_a | ok_b); the affine
// combine of an earlier (a_1, b_1) with a later (a_2, b_2) is (a_2 * a_1,
// a_2 * b_1 + b_2), as in the JAX package's _scan_block.  Built with
// --fmad=false: a*b+c rounds twice.  A double moves through the warp
// shuffle as two 32-bit words (srk_shfl_up).
//
// The kernel, srk_scan_pipe_kernel, takes one CTA of 256 threads per row,
// walking the row's chunks in order (every main path has at least 1,024
// rows), and is designed for the card's memory:
//
// * A prefetch ring.  A ring of STAGES chunk stages in shared memory
//   (srk_ring: 4 stages of a 4 KB chunk for an f32 or int32 sum or max, 3
//   for an 8 KB one (f64, affine, a fill of one 4-byte array), 2 above),
//   filled by cp.async: the next STAGES - 1 chunks are in flight while a
//   chunk is scanned and stored, 12-16 KB a CTA, about 96-128 KB an SM at
//   8 CTAs of 256 threads (a kernel that loads one chunk at a time has 4
//   KB a CTA in flight, and none while it scans).  cp.async and not TMA bulk copies: each
//   thread copies exactly the elements it folds (piece p of thread t of a
//   stream at (p * 256 + t) * width in the stage, so a warp's copies and
//   reads of a piece fall on consecutive words), waits for its own copies
//   with cp.async.wait_group and reads them back: no mbarrier, no proxy
//   fence, no elected thread, and the scalar variant is the same code
//   with narrower copies.  A stage is refilled in the chunk after the one
//   that read it, after that chunk's barriers.
// * 16-byte accesses.  The vector variant (entries *_vec) copies and
//   stores a thread's 4 elements of each array as 16-byte pieces (one for
//   4-byte elements, two for 8-byte ones; f32 and int32 neighbouring
//   threads on neighbouring 16-byte addresses).  It needs n x the element
//   size of every array to be a multiple of 16 and 16-byte-aligned base
//   pointers (every main path: n = 480,000, 96,000, 48,000); the entry
//   returns -2 where they do not hold.  The scalar variant (no suffix)
//   moves one element a copy and a store and takes any n and pointers: the
//   wrapper (ops/scan_kernel.py) picks the variant.  Both are the same
//   kernel.
// * Two barriers a chunk (srk_cta_scan2 in row_scan.cuh), not three: the
//   carry and the warp totals in double-buffered shared slots.
//
// Past the row's end the elements are the identity; copies past it are
// not issued.
//
// Every body is written twice from one description: the kernels (cp.async,
// shuffles, shared memory) and the host build (g++), which runs the same
// phases over the same thread and lane indices with arrays (the ring's
// copies as memcpy), for the CPU tests.

#include "row_scan.cuh"

#ifdef __CUDACC__
#define SRK_STREAM , void* stream
#define SRK_STREAM_ARG , stream
#else
#define SRK_STREAM
#define SRK_STREAM_ARG
#endif

// -- moving pieces: cp.async into the ring, 16-byte loads and stores ------

// copy W bytes from device memory into the ring (W-aligned both)
template <int W, bool L1>
SRK_HD void srk_cp_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (W == 16 && !L1)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(W)
                 : "memory");
#else
  memcpy(dst, src, W);
#endif
}

SRK_HD void srk_cp_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait until at most N of this thread's copy groups are pending
template <int N>
SRK_HD void srk_cp_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// W bytes from src to dst (W-aligned both): one load and one store
template <int W>
SRK_HD void srk_move(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  if (W == 16) {
    *(uint4*)dst = *(const uint4*)src;
  } else if (W == 8) {
    *(uint2*)dst = *(const uint2*)src;
  } else {
    *(unsigned*)dst = *(const unsigned*)src;
  }
#else
  memcpy(dst, src, W);
#endif
}

// One array ("stream") of a row scan, element type E: a thread's
// SRK_SCAN_ITEMS elements as P pieces of PER elements (W bytes).  In a
// ring stage the stream takes SRK_SCAN_CHUNK elements, piece p of thread
// tid at (p * SRK_SCAN_THREADS + tid) * W.
template <typename E, bool VEC>
struct srk_stream {
  static constexpr int W = VEC ? 16 : (int)sizeof(E);
  static constexpr int PER = W / (int)sizeof(E);
  static constexpr int P = SRK_SCAN_ITEMS / PER;
  static constexpr int BYTES = SRK_SCAN_CHUNK * (int)sizeof(E);

  // the thread's elements from i0 of row ``src`` into stage ``st``
  SRK_HD static void copy(unsigned char* st, const E* src, int tid, int i0,
                          int n) {
    for (int p = 0; p < P; ++p)
      if (i0 + p * PER < n)
        srk_cp_async<W, sizeof(E) == 8>(
            st + (p * SRK_SCAN_THREADS + tid) * W, src + i0 + p * PER);
  }
  SRK_HD static void read(const unsigned char* st, int tid, E* out) {
    for (int p = 0; p < P; ++p)
      srk_move<W>(out + p * PER, st + (p * SRK_SCAN_THREADS + tid) * W);
  }
  SRK_HD static void store(E* dst, int i0, int n, const E* v) {
    for (int p = 0; p < P; ++p)
      if (i0 + p * PER < n) srk_move<W>(dst + i0 + p * PER, v + p * PER);
  }
  // the vector variant's condition for one array
  SRK_HD static bool fits(const void* base, int n) {
    return (uintptr_t)base % 16 == 0 && ((size_t)n * sizeof(E)) % 16 == 0;
  }
};

// -- the kinds: element type, identity, combine, copy, read and put -------
//
// copy/read/put: a thread's SRK_SCAN_ITEMS elements through the ring, BYTES
// the input bytes an element (a stage holds SRK_SCAN_CHUNK x BYTES).

// sum and max: one array in, one out
template <typename V, template <typename> class C>
struct srk_scan1 {
  typedef V T;
  const V* x;
  V* y;
  int n;
  static constexpr int BYTES = sizeof(V);
  SRK_HD static T id() { return C<V>::id(); }
  SRK_HD static T op(T a, T b) { return C<V>::op(a, b); }
  template <bool VEC>
  SRK_HD void copy(unsigned char* st, size_t row, int tid, int i0) const {
    srk_stream<V, VEC>::copy(st, x + row * (size_t)n, tid, i0, n);
  }
  template <bool VEC>
  SRK_HD void read(const unsigned char* st, int tid, T* loc) const {
    alignas(16) V v[SRK_SCAN_ITEMS];
    srk_stream<V, VEC>::read(st, tid, v);
    for (int k = 0; k < SRK_SCAN_ITEMS; ++k) loc[k] = v[k];
  }
  template <bool VEC>
  SRK_HD void put(size_t row, int i0, const T* loc) const {
    alignas(16) V v[SRK_SCAN_ITEMS];
    for (int k = 0; k < SRK_SCAN_ITEMS; ++k) v[k] = loc[k];
    srk_stream<V, VEC>::store(y + row * (size_t)n, i0, n, v);
  }
  SRK_HD bool fits() const {
    return srk_stream<V, true>::fits(x, n) && srk_stream<V, true>::fits(y, n);
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
  static constexpr int BYTES = K * sizeof(V) + sizeof(int);
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
  // in a stage: the K value streams, then the mask
  template <bool VEC>
  SRK_HD void copy(unsigned char* st, size_t row, int tid, int i0) const {
    const size_t plane = (size_t)rows * (size_t)n, r = row * (size_t)n;
    for (int k = 0; k < K; ++k)
      srk_stream<V, VEC>::copy(st + k * srk_stream<V, VEC>::BYTES,
                               vals + k * plane + r, tid, i0, n);
    srk_stream<int, VEC>::copy(st + K * srk_stream<V, VEC>::BYTES, mask + r,
                               tid, i0, n);
  }
  template <bool VEC>
  SRK_HD void read(const unsigned char* st, int tid, T* loc) const {
    for (int k = 0; k < K; ++k) {
      alignas(16) V v[SRK_SCAN_ITEMS];
      srk_stream<V, VEC>::read(st + k * srk_stream<V, VEC>::BYTES, tid, v);
      for (int j = 0; j < SRK_SCAN_ITEMS; ++j) loc[j].v[k] = v[j];
    }
    alignas(16) int m[SRK_SCAN_ITEMS];
    srk_stream<int, VEC>::read(st + K * srk_stream<V, VEC>::BYTES, tid, m);
    for (int j = 0; j < SRK_SCAN_ITEMS; ++j) loc[j].ok = m[j];
  }
  template <bool VEC>
  SRK_HD void put(size_t row, int i0, const T* loc) const {
    const size_t plane = (size_t)rows * (size_t)n, r = row * (size_t)n;
    for (int k = 0; k < K; ++k) {
      alignas(16) V v[SRK_SCAN_ITEMS];
      for (int j = 0; j < SRK_SCAN_ITEMS; ++j) v[j] = loc[j].v[k];
      srk_stream<V, VEC>::store(out_vals + k * plane + r, i0, n, v);
    }
    alignas(16) int m[SRK_SCAN_ITEMS];
    for (int j = 0; j < SRK_SCAN_ITEMS; ++j) m[j] = loc[j].ok;
    srk_stream<int, VEC>::store(out_ok + r, i0, n, m);
  }
  SRK_HD bool fits() const {
    return srk_stream<V, true>::fits(vals, n) &&
           srk_stream<V, true>::fits(out_vals, n) &&
           srk_stream<int, true>::fits(mask, n) &&
           srk_stream<int, true>::fits(out_ok, n);
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
  static constexpr int BYTES = 2 * sizeof(float);
  SRK_HD static T id() { return T{1.0f, 0.0f}; }
  SRK_HD static T op(T e, T l) { return T{l.a * e.a, l.a * e.b + l.b}; }
  // in a stage: A, then B
  template <bool VEC>
  SRK_HD void copy(unsigned char* st, size_t row, int tid, int i0) const {
    typedef srk_stream<float, VEC> F;
    const size_t r = row * (size_t)n;
    F::copy(st, a + r, tid, i0, n);
    F::copy(st + F::BYTES, b + r, tid, i0, n);
  }
  template <bool VEC>
  SRK_HD void read(const unsigned char* st, int tid, T* loc) const {
    typedef srk_stream<float, VEC> F;
    alignas(16) float va[SRK_SCAN_ITEMS], vb[SRK_SCAN_ITEMS];
    F::read(st, tid, va);
    F::read(st + F::BYTES, tid, vb);
    for (int k = 0; k < SRK_SCAN_ITEMS; ++k) loc[k] = T{va[k], vb[k]};
  }
  template <bool VEC>
  SRK_HD void put(size_t row, int i0, const T* loc) const {
    typedef srk_stream<float, VEC> F;
    alignas(16) float va[SRK_SCAN_ITEMS], vb[SRK_SCAN_ITEMS];
    for (int k = 0; k < SRK_SCAN_ITEMS; ++k) {
      va[k] = loc[k].a;
      vb[k] = loc[k].b;
    }
    const size_t r = row * (size_t)n;
    F::store(out_a + r, i0, n, va);
    F::store(out_b + r, i0, n, vb);
  }
  SRK_HD bool fits() const {
    typedef srk_stream<float, true> F;
    return F::fits(a, n) && F::fits(b, n) && F::fits(out_a, n) &&
           F::fits(out_b, n);
  }
};

// -- the ring: stages by the bytes a chunk brings in ----------------------

template <class S>
struct srk_ring {
  static constexpr int STAGE = SRK_SCAN_CHUNK * S::BYTES;
  static constexpr int STAGES = STAGE <= 4096 ? 4 : STAGE <= 8192 ? 3 : 2;
  static constexpr int BYTES = STAGE * STAGES;
};

// phase A, after the thread's elements were read from the ring: the
// identity past the row's end, then the fold
template <class S>
SRK_HD void srk_pipe_local(int i0, int n, typename S::T* loc) {
  for (int k = 0; k < SRK_SCAN_ITEMS; ++k)
    if (i0 + k >= n) loc[k] = S::id();
  srk_scan_fold<typename S::T, S>(loc);
}

#ifdef __CUDACC__

extern __shared__ __align__(16) unsigned char srk_ring_smem[];

// the main path's kernel: one CTA per row, the ring of srk_ring<S> in
// dynamic shared memory
template <class S, bool VEC>
__global__ void __launch_bounds__(SRK_SCAN_THREADS)
    srk_scan_pipe_kernel(S s, int n) {
  typedef typename S::T T;
  typedef srk_ring<S> R;
  __shared__ T warp_tot[2][SRK_SCAN_WARPS];
  __shared__ T carry_s[2];
  unsigned char* ring = srk_ring_smem;
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const int chunks = (n + SRK_SCAN_CHUNK - 1) / SRK_SCAN_CHUNK;
  if (tid == SRK_SCAN_THREADS - 1) carry_s[1] = S::id();
#pragma unroll
  for (int c = 0; c < R::STAGES; ++c) {      // the first STAGES chunks
    if (c < chunks)
      s.template copy<VEC>(ring + c * R::STAGE, row, tid,
                           c * SRK_SCAN_CHUNK + tid * SRK_SCAN_ITEMS);
    srk_cp_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    const int i0 = c * SRK_SCAN_CHUNK + tid * SRK_SCAN_ITEMS;
    // refill the stage chunk c - 1 read (every thread has passed chunk
    // c - 1's barriers since) with chunk c - 1 + STAGES; one group a chunk
    if (c > 0 && c - 1 + R::STAGES < chunks)
      s.template copy<VEC>(ring + ((c - 1) % R::STAGES) * R::STAGE, row, tid,
                           i0 + (R::STAGES - 1) * SRK_SCAN_CHUNK);
    if (c > 0) srk_cp_commit();
    srk_cp_wait<R::STAGES - 1>();            // chunk c's copies landed
    alignas(16) T loc[SRK_SCAN_ITEMS];
    s.template read<VEC>(ring + (c % R::STAGES) * R::STAGE, tid, loc);
    srk_pipe_local<S>(i0, n, loc);                            // A
    srk_cta_scan2<T, S>(loc, c, warp_tot, carry_s);           // B-D
    s.template put<VEC>(row, i0, loc);
  }
}

template <class S, bool VEC>
static int srk_pipe_launch(const S& s, int rows, int n, void* stream) {
  const int smem = srk_ring<S>::BYTES;
  if (rows > 0 && n > 0) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          srk_scan_pipe_kernel<S, VEC>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    srk_scan_pipe_kernel<S, VEC>
        <<<rows, SRK_SCAN_THREADS, smem, (cudaStream_t)stream>>>(s, n);
  }
  return (int)cudaGetLastError();
}

// CTAs an SM holds and the dynamic shared memory of one pipelined build
template <class S, bool VEC>
static int srk_pipe_shape(int* ctas, int* smem) {
  *smem = srk_ring<S>::BYTES;
  if (*smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        srk_scan_pipe_kernel<S, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, srk_scan_pipe_kernel<S, VEC>, SRK_SCAN_THREADS, *smem);
}

#else  // the host build: the same phases over arrays

// the pipelined kernel's row: the ring's stages, copies, reads and stores
// in the kernel's order, each thread in turn
template <class S, bool VEC>
static void srk_pipe_row_host(const S& s, size_t row, int n) {
  typedef typename S::T T;
  typedef srk_ring<S> R;
  alignas(16) static unsigned char ring[R::BYTES];
  static T loc[SRK_SCAN_THREADS][SRK_SCAN_ITEMS];
  T carry_s[2];
  carry_s[1] = S::id();
  const int chunks = (n + SRK_SCAN_CHUNK - 1) / SRK_SCAN_CHUNK;
  for (int c = 0; c < R::STAGES && c < chunks; ++c)
    for (int tid = 0; tid < SRK_SCAN_THREADS; ++tid)
      s.template copy<VEC>(ring + c * R::STAGE, row, tid,
                           c * SRK_SCAN_CHUNK + tid * SRK_SCAN_ITEMS);
  for (int c = 0; c < chunks; ++c) {
    const int base = c * SRK_SCAN_CHUNK;
    if (c > 0 && c - 1 + R::STAGES < chunks)
      for (int tid = 0; tid < SRK_SCAN_THREADS; ++tid)
        s.template copy<VEC>(ring + ((c - 1) % R::STAGES) * R::STAGE, row,
                             tid, base + (R::STAGES - 1) * SRK_SCAN_CHUNK +
                                      tid * SRK_SCAN_ITEMS);
    for (int tid = 0; tid < SRK_SCAN_THREADS; ++tid) {        // A
      s.template read<VEC>(ring + (c % R::STAGES) * R::STAGE, tid, loc[tid]);
      srk_pipe_local<S>(base + tid * SRK_SCAN_ITEMS, n, loc[tid]);
    }
    srk_cta_scan2_host<T, S>(loc, c, carry_s);                // B-D
    for (int tid = 0; tid < SRK_SCAN_THREADS; ++tid)
      s.template put<VEC>(row, base + tid * SRK_SCAN_ITEMS, loc[tid]);
  }
}

template <class S, bool VEC>
static int srk_pipe_host(const S& s, int rows, int n) {
  for (int r = 0; r < rows; ++r) srk_pipe_row_host<S, VEC>(s, (size_t)r, n);
  return 0;
}

#endif

// -- the two forms of every entry -------------------------------------------

enum { SRK_SCALAR = 0, SRK_VEC = 1 };

template <class S>
static int srk_scan_run(const S& s, int rows, int n, int form SRK_STREAM) {
  if (form == SRK_VEC && !s.fits()) return -2;
#ifdef __CUDACC__
  if (form == SRK_VEC) return srk_pipe_launch<S, true>(s, rows, n, stream);
  return srk_pipe_launch<S, false>(s, rows, n, stream);
#else
  if (form == SRK_VEC) return srk_pipe_host<S, true>(s, rows, n);
  return srk_pipe_host<S, false>(s, rows, n);
#endif
}

template <typename V>
static int srk_fill_run(const V* vals, const int* mask, V* out_vals,
                        int* out_ok, int k, int rows, int n,
                        int form SRK_STREAM) {
  switch (k) {
    case 1:
      return srk_scan_run(
          srk_scan_fill<V, 1>{vals, mask, out_vals, out_ok, rows, n}, rows,
          n, form SRK_STREAM_ARG);
    case 2:
      return srk_scan_run(
          srk_scan_fill<V, 2>{vals, mask, out_vals, out_ok, rows, n}, rows,
          n, form SRK_STREAM_ARG);
    case 3:
      return srk_scan_run(
          srk_scan_fill<V, 3>{vals, mask, out_vals, out_ok, rows, n}, rows,
          n, form SRK_STREAM_ARG);
    case 4:
      return srk_scan_run(
          srk_scan_fill<V, 4>{vals, mask, out_vals, out_ok, rows, n}, rows,
          n, form SRK_STREAM_ARG);
  }
  return -1;
}

// -- entry points: <name> (the scalar variant) and <name>_vec; the host
// build takes no stream ----------------------------------------------------

#define SRK_FORMS(NAME, PARAMS, CALL)                                     \
  extern "C" int NAME PARAMS { return CALL(SRK_SCALAR); }                 \
  extern "C" int NAME##_vec PARAMS { return CALL(SRK_VEC); }

#define SRK_SCAN1_PARAMS(V) (const V* x, V* y, int rows, int n SRK_STREAM)
#define SRK_SCAN1_CALL(V, C)                                                \
  [&](int form) {                                                           \
    return srk_scan_run(srk_scan1<V, C>{x, y, n}, rows, n,                  \
                        form SRK_STREAM_ARG);                               \
  }

SRK_FORMS(srk_scan_sum_f32, SRK_SCAN1_PARAMS(float),
          SRK_SCAN1_CALL(float, srk_add))
SRK_FORMS(srk_scan_sum_i32, SRK_SCAN1_PARAMS(int),
          SRK_SCAN1_CALL(int, srk_add))
SRK_FORMS(srk_scan_sum_f64, SRK_SCAN1_PARAMS(double),
          SRK_SCAN1_CALL(double, srk_add))
SRK_FORMS(srk_scan_max_f32, SRK_SCAN1_PARAMS(float),
          SRK_SCAN1_CALL(float, srk_max))
SRK_FORMS(srk_scan_max_i32, SRK_SCAN1_PARAMS(int),
          SRK_SCAN1_CALL(int, srk_max))
SRK_FORMS(srk_scan_max_f64, SRK_SCAN1_PARAMS(double),
          SRK_SCAN1_CALL(double, srk_max))

SRK_FORMS(srk_scan_affine_f32,
          (const float* a, const float* b, float* out_a, float* out_b,
           int rows, int n SRK_STREAM),
          [&](int form) {
            return srk_scan_run(srk_scan_affine{a, b, out_a, out_b, n}, rows,
                                n, form SRK_STREAM_ARG);
          })

#define SRK_FILL_PARAMS(V)                                                  \
  (const V* vals, const int* mask, V* out_vals, int* out_ok, int k,         \
   int rows, int n SRK_STREAM)
#define SRK_FILL_CALL(V)                                                    \
  [&](int form) {                                                           \
    return srk_fill_run<V>(vals, mask, out_vals, out_ok, k, rows, n,        \
                           form SRK_STREAM_ARG);                            \
  }

SRK_FORMS(srk_scan_fill_f32, SRK_FILL_PARAMS(float), SRK_FILL_CALL(float))
SRK_FORMS(srk_scan_fill_i32, SRK_FILL_PARAMS(int), SRK_FILL_CALL(int))
SRK_FORMS(srk_scan_fill_f64, SRK_FILL_PARAMS(double), SRK_FILL_CALL(double))

#ifdef __CUDACC__

// The pipelined kernel's shape for chip_smoke.py's record: the CTAs an SM
// holds (the card's occupancy query) and the ring's bytes, for kind 0 sum,
// 1 max, 2 fill of k arrays, 3 affine; dtype 0 f32, 1 int32, 2 f64; vec 0
// or 1.
template <class S>
static int srk_scan_shape_vec(int vec, int* ctas, int* smem) {
  return vec ? srk_pipe_shape<S, true>(ctas, smem)
             : srk_pipe_shape<S, false>(ctas, smem);
}

template <typename V>
static int srk_scan_shape_of(int kind, int k, int vec, int* ctas,
                             int* smem) {
  switch (kind * 8 + (kind == 2 ? k : 0)) {
    case 0:
      return srk_scan_shape_vec<srk_scan1<V, srk_add> >(vec, ctas, smem);
    case 8:
      return srk_scan_shape_vec<srk_scan1<V, srk_max> >(vec, ctas, smem);
    case 17:
      return srk_scan_shape_vec<srk_scan_fill<V, 1> >(vec, ctas, smem);
    case 18:
      return srk_scan_shape_vec<srk_scan_fill<V, 2> >(vec, ctas, smem);
    case 19:
      return srk_scan_shape_vec<srk_scan_fill<V, 3> >(vec, ctas, smem);
    case 20:
      return srk_scan_shape_vec<srk_scan_fill<V, 4> >(vec, ctas, smem);
    case 24:
      return srk_scan_shape_vec<srk_scan_affine>(vec, ctas, smem);
  }
  return -1;
}

extern "C" int srk_scan_shape(int kind, int dtype, int k, int vec,
                              int* ctas, int* smem) {
  switch (dtype) {
    case 0:
      return srk_scan_shape_of<float>(kind, k, vec, ctas, smem);
    case 1:
      return srk_scan_shape_of<int>(kind, k, vec, ctas, smem);
    case 2:
      return srk_scan_shape_of<double>(kind, k, vec, ctas, smem);
  }
  return -1;
}

#endif
