// The Sample player: kernel K7 of srack_tpu_torch (ops/sample_kernel.py).
//
// Replaces srack_tpu/ops/sample_kernel.py::_fused_rows, the Pallas kernel
// that computes the whole Sample player of modules/sample.py's block form in
// one pass: gate (and CV) lanes [R, n] and per-row tables [R, K] in, audio
// [R, n] and the end state out.  Per row, with base = wav_sr / sample_rate:
//
//   trig_t    = gate_t > 0 and not gate_{t-1} > 0 (gate_{-1}: gate_last)
//   rate_t    = base * exp2f(cv_t), or base when CV is unconnected
//   cum_ex_t  = (inclusive prefix sum of rate)_t - rate_t, or base * t
//   m_t       = running max of (trig ? cum_ex : -1)   (the last trigger's
//               cum_ex: rates are non-negative, so cum_ex never decreases)
//   s_t       = m_t >= 0 ? cum_ex_t - m_t
//               : (playing ? cum_ex_t + pos : pos)
//   crossed_t = s_t >= length
//   out_t     = length > 0 ? table[crossed_t ? 0 : clip(s_t, 0, K-1)] : 0
//
// and at t = n-1 the end state: playing = (m >= 0 or playing) and not
// crossed; pos = playing ? s + rate : (crossed ? 0 : pos); gate_last =
// gate_{n-1} > 0.  s is clamped to [0, K-1] as a float before it becomes an
// int (a conversion out of range is undefined in the host build); where it
// is at or past the length the read is table[0] anyway.
//
// The prefix sum combines in K4's order: the CTA scan of row_scan.cuh, the
// one row_scan.cu runs, so that K7 equals its unfused form (K4's sum and
// max, then the row gather K6) bit for bit.  The max is order-free.  The
// constant-rate entry (CV unconnected) reads no CV lane and sums nothing:
// base * t is one exact product, as the JAX kernel's cv_none path.
//
// Launch shape: K4's.  One CTA of SRK_SCAN_THREADS threads per row (voice),
// the row's SRK_SCAN_CHUNK-sample chunks in order, the sum's and the max's
// carries in registers.  Threads run along time and read neighbouring
// frames of their row's table (through L1/L2): a thread per voice would
// touch 32 rows of [V, K] per warp load.  Bound: bytes.  Gate in and audio
// out, 8 bytes per sample (3.93 GB at [1,024, 480,000], 1.17 ms at 3.35
// TB/s), the CV lane 4 more when connected, and at most one table word per
// sample played.
//
// The per-row body is written twice from one description: the kernel and
// srk_play_row_host, which runs the same phases over the same thread
// indices with arrays (srk_cta_scan_host), for the host build (g++) that
// the CPU tests check against the unfused form on the host build of K4.

#include "row_scan.cuh"

#ifdef __CUDA_ARCH__
#define SRK_LDG(p) __ldg(p)
#else
#define SRK_LDG(p) (*(p))
#endif

// one row's operands and the per-sample steps that need no scan
struct srk_play_row {
  const float* gate;   // [n]
  const float* cv;     // [n] or null (constant rate)
  const float* tbl;    // [K]
  float* out;          // [n]
  float base, pos0, len_f;
  int playing0, last0, length, k, n;

  SRK_HD bool above(int i) const {
    return i < 0 ? last0 != 0 : gate[i] > 0.0f;
  }
  SRK_HD float rate(int i) const {
    return cv ? base * exp2f(cv[i]) : base;
  }
  // sample i once its exclusive prefix sum and its fill are known; the last
  // sample also writes the end state
  SRK_HD void emit(int i, float cum_ex, float m, float rate, float* pos_end,
                   int* playing_end, int* gate_last_end) const {
    const bool htr = m >= 0.0f;
    const float s = htr ? cum_ex - m
                        : (playing0 ? cum_ex + pos0 : pos0);
    const bool crossed = s >= len_f;
    float v = 0.0f;
    if (length > 0) {
      const int j =
          crossed ? 0 : (int)fminf(fmaxf(s, 0.0f), (float)(k - 1));
      v = SRK_LDG(tbl + j);
    }
    out[i] = v;
    if (i == n - 1) {
      const bool playing = (htr || playing0) && !crossed;
      *pos_end = playing ? s + rate : (crossed ? 0.0f : pos0);
      *playing_end = playing;
      *gate_last_end = above(i);
    }
  }
};

struct srk_play_args {
  const float* gate;
  const float* cv;
  const float* table;
  const float* base;
  const float* pos0;
  const int* playing0;
  const int* gate_last0;
  const int* length;
  float* out;
  float* pos_end;
  int* playing_end;
  int* gate_last_end;
  int n, k;

  SRK_HD srk_play_row row(size_t r) const {
    srk_play_row p;
    p.gate = gate + r * (size_t)n;
    p.cv = cv ? cv + r * (size_t)n : nullptr;
    p.tbl = table + r * (size_t)k;
    p.out = out + r * (size_t)n;
    p.base = base[r];
    p.pos0 = pos0[r];
    p.len_f = (float)length[r];
    p.playing0 = playing0[r];
    p.last0 = gate_last0[r];
    p.length = length[r];
    p.k = k;
    p.n = n;
    return p;
  }
};

// phase A of one thread: the rates and, with CV, the rates folded for the
// sum's scan; at constant rate the exclusive sums themselves
template <bool CV>
SRK_HD void srk_play_load(const srk_play_row& p, int i0, float* rate,
                          float* cum) {
  for (int k = 0; k < SRK_SCAN_ITEMS; ++k) {
    const int i = i0 + k;
    rate[k] = i < p.n ? p.rate(i) : 0.0f;   // past the end: the identity
    cum[k] = CV ? rate[k] : p.base * (float)i;
  }
  if (CV) srk_scan_fold<float, srk_add<float> >(cum);
}

// the fill's inputs from the exclusive sums, folded for the max scan
SRK_HD void srk_play_marks(const srk_play_row& p, int i0, const float* cum_ex,
                           float* m) {
  for (int k = 0; k < SRK_SCAN_ITEMS; ++k) {
    const int i = i0 + k;
    const bool trig = i < p.n && p.above(i) && !p.above(i - 1);
    m[k] = trig ? cum_ex[k] : -1.0f;
  }
  srk_scan_fold<float, srk_max<float> >(m);
}

#ifdef __CUDACC__

template <bool CV>
__global__ void __launch_bounds__(SRK_SCAN_THREADS)
    srk_sample_play_kernel(srk_play_args a) {
  __shared__ float wt_sum[SRK_SCAN_WARPS], wt_max[SRK_SCAN_WARPS];
  __shared__ float cs_sum, cs_max;
  const size_t r = blockIdx.x;
  const srk_play_row p = a.row(r);
  float c_sum = srk_add<float>::id(), c_max = srk_max<float>::id();
  for (int base = 0; base < p.n; base += SRK_SCAN_CHUNK) {
    const int i0 = base + threadIdx.x * SRK_SCAN_ITEMS;
    float rate[SRK_SCAN_ITEMS], cum[SRK_SCAN_ITEMS], m[SRK_SCAN_ITEMS];
    srk_play_load<CV>(p, i0, rate, cum);
    if (CV) {
      srk_cta_scan<float, srk_add<float> >(cum, c_sum, wt_sum, &cs_sum);
#pragma unroll
      for (int k = 0; k < SRK_SCAN_ITEMS; ++k) cum[k] = cum[k] - rate[k];
    }
    srk_play_marks(p, i0, cum, m);
    srk_cta_scan<float, srk_max<float> >(m, c_max, wt_max, &cs_max);
#pragma unroll
    for (int k = 0; k < SRK_SCAN_ITEMS; ++k)
      if (i0 + k < p.n)
        p.emit(i0 + k, cum[k], m[k], rate[k], a.pos_end + r,
               a.playing_end + r, a.gate_last_end + r);
  }
}

static int srk_play_launch(const srk_play_args& a, int rows, void* stream) {
  if (rows > 0 && a.n > 0) {
    if (a.cv)
      srk_sample_play_kernel<true>
          <<<rows, SRK_SCAN_THREADS, 0, (cudaStream_t)stream>>>(a);
    else
      srk_sample_play_kernel<false>
          <<<rows, SRK_SCAN_THREADS, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

#define SRK_PLAY_RUN(a, rows) return srk_play_launch(a, rows, stream)
#define SRK_STREAM , void* stream

#else  // the host build: the same phases over arrays

template <bool CV>
static void srk_play_row_host(const srk_play_args& a, size_t r) {
  static float rate[SRK_SCAN_THREADS][SRK_SCAN_ITEMS];
  static float cum[SRK_SCAN_THREADS][SRK_SCAN_ITEMS];
  static float m[SRK_SCAN_THREADS][SRK_SCAN_ITEMS];
  const srk_play_row p = a.row(r);
  float c_sum = srk_add<float>::id(), c_max = srk_max<float>::id();
  for (int base = 0; base < p.n; base += SRK_SCAN_CHUNK) {
    for (int tid = 0; tid < SRK_SCAN_THREADS; ++tid)
      srk_play_load<CV>(p, base + tid * SRK_SCAN_ITEMS, rate[tid], cum[tid]);
    if (CV) {
      srk_cta_scan_host<float, srk_add<float> >(cum, c_sum);
      for (int tid = 0; tid < SRK_SCAN_THREADS; ++tid)
        for (int k = 0; k < SRK_SCAN_ITEMS; ++k)
          cum[tid][k] = cum[tid][k] - rate[tid][k];
    }
    for (int tid = 0; tid < SRK_SCAN_THREADS; ++tid)
      srk_play_marks(p, base + tid * SRK_SCAN_ITEMS, cum[tid], m[tid]);
    srk_cta_scan_host<float, srk_max<float> >(m, c_max);
    for (int tid = 0; tid < SRK_SCAN_THREADS; ++tid)
      for (int k = 0; k < SRK_SCAN_ITEMS; ++k) {
        const int i = base + tid * SRK_SCAN_ITEMS + k;
        if (i < p.n)
          p.emit(i, cum[tid][k], m[tid][k], rate[tid][k], a.pos_end + r,
                 a.playing_end + r, a.gate_last_end + r);
      }
  }
}

static int srk_play_host(const srk_play_args& a, int rows) {
  for (int r = 0; r < rows; ++r) {
    if (a.cv)
      srk_play_row_host<true>(a, (size_t)r);
    else
      srk_play_row_host<false>(a, (size_t)r);
  }
  return 0;
}

#define SRK_PLAY_RUN(a, rows) return srk_play_host(a, rows)
#define SRK_STREAM

#endif

// -- entry point (the host build takes no stream) ---------------------------
//
// cv = null takes the constant-rate entry.  playing0, gate_last0 and the
// playing/gate_last outputs are int32 0/1 per row.

extern "C" int srk_sample_play(const float* gate, const float* cv,
                               const float* table, const float* base,
                               const float* pos0, const int* playing0,
                               const int* gate_last0, const int* length,
                               float* out, float* pos_end, int* playing_end,
                               int* gate_last_end, int rows, int n,
                               int k SRK_STREAM) {
  const srk_play_args a{gate, cv, table, base, pos0, playing0, gate_last0,
                        length, out, pos_end, playing_end, gate_last_end,
                        n, k};
  SRK_PLAY_RUN(a, rows);
}
