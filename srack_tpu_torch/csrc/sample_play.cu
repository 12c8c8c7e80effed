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
// The entry, srk_sample_play: a CTA takes VT voices with NWV warps each (8
// and 4, chosen by timing the shapes of SRK_TILE_SHAPES on the card) and
// walks their chunks of SRK_SCAN_CHUNK samples.  Each chunk's gate (and
// CV) of the CTA's voices is staged in shared memory with cp.async a chunk
// ahead, read from a 2-D view of any strides: [R, n] rows along time
// (16-byte copies where aligned) or the block engine's transposed stage
// outputs ([V, n] views of [n, V] rows) across voices, a time step's 8
// voices one 32-byte sector, so no wrapper copies a lane.  A voice's warps
// take K4's 8 warps in turn (phase A in registers, phase B as shuffles),
// share their totals through shared memory for phase C and finish with
// phase D: the order of combination is a property of positions, not of
// threads.
//
// Bound: bytes.  Gate in and audio out, 8 bytes per sample (3.93 GB at
// [1,024, 480,000], 1.17 ms at 3.35 TB/s), the CV lane 4 more when
// connected, and at most one table word per sample played.  The kernel
// prefetches a chunk ahead; what it loses to the bound is latency:
// 32 warps an SM with its table reads, scans and barriers per chunk.
//
// The body is written twice from one description: the kernel and a host
// form (g++) that runs the same phases over arrays of the lanes' values,
// which the CPU tests check against the unfused form on the host build of
// K4.

#include "row_scan.cuh"
#include "pipeline.cuh"

#ifdef __CUDA_ARCH__
#define SRK_LDG(p) __ldg(p)
#else
#define SRK_LDG(p) (*(p))
#endif

#ifdef __CUDACC__
#define SRK_STREAM , void* stream
#else
#define SRK_STREAM
#endif

// ===========================================================================
// The main path's kernel: tiles of voices staged in shared memory.
//
// A CTA of VT x NWV warps takes VT voices (rows) and walks their chunks of
// SRK_SCAN_CHUNK samples, the chunk's tile of gate (and CV) in a double
// buffer that cp.async fills a chunk ahead.  A voice's NWV warps each take
// 8 / NWV of K4's warps in turn; each warp writes its voice's output, 512
// contiguous bytes per K4 warp.  The previous gate element comes from the
// tile, or from the chunk before it.

#define SRK_PLAY_VT 8                         // the host form's tile
#define SRK_PLAY_ROW (SRK_SCAN_CHUNK + 4)     // a voice's row in the tile
#define SRK_PLAY_WP SRK_SCAN_WARPS            // K4's warps, walked in turn
#define SRK_PLAY_WI (32 * SRK_SCAN_ITEMS)     // elements of one K4 warp

struct srk_tile_args {
  const float* gate;
  long long g_rs, g_ts;                       // row and time strides
  const float* cv;                            // null: constant rate
  long long c_rs, c_ts;
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
  int rows, n, k;
  int vec;  // 1: time stride 1 with 16-byte aligned rows (16-byte copies)
};

// one voice's constants
struct srk_tile_voice {
  const float* tbl;
  float* out;
  float base, pos0, len_f;
  int playing0, last0, length, k, n;

  SRK_HD void init(const srk_tile_args& a, size_t r) {
    tbl = a.table + r * (size_t)a.k;
    out = a.out + r * (size_t)a.n;
    base = a.base[r];
    pos0 = a.pos0[r];
    len_f = (float)a.length[r];
    playing0 = a.playing0[r];
    last0 = a.gate_last0[r];
    length = a.length[r];
    k = a.k;
    n = a.n;
  }
  // element e of the chunk at t0 (gate tile gt, CV tile ct) as phase A
  // loads it: the rate, and the sum's input (at constant rate the
  // exclusive sum itself)
  template <bool CV>
  SRK_HD float rate(const float* ct, int e, int i) const {
    return i < n ? (CV ? base * exp2f(ct[e]) : base) : 0.0f;
  }
  template <bool CV>
  SRK_HD float sum_in(const float* ct, int e, int i) const {
    return CV ? rate<CV>(ct, e, i) : base * (float)i;
  }
  // the fill's input: the exclusive sum at a trigger, else -1
  SRK_HD float mark(const float* gt, int e, int i, float cum_ex,
                    bool prev_above) const {
    const bool above_prev = e > 0 ? gt[e - 1] > 0.0f : prev_above;
    const bool trig = i < n && gt[e] > 0.0f && !above_prev;
    return trig ? cum_ex : -1.0f;
  }
  // sample i's output and, at the last sample, the end state
  SRK_HD float emit(int i, float cum_ex, float m, float rate, bool above,
                    float* pos_end, int* playing_end,
                    int* gate_last_end) const {
    const bool htr = m >= 0.0f;
    const float s = htr ? cum_ex - m : (playing0 ? cum_ex + pos0 : pos0);
    const bool crossed = s >= len_f;
    float v = 0.0f;
    if (length > 0) {
      const int j =
          crossed ? 0 : (int)fminf(fmaxf(s, 0.0f), (float)(k - 1));
      v = SRK_LDG(tbl + j);
    }
    if (i == n - 1) {
      const bool playing = (htr || playing0) && !crossed;
      *pos_end = playing ? s + rate : (crossed ? 0.0f : pos0);
      *playing_end = playing;
      *gate_last_end = above;
    }
    return v;
  }
};

// phase C over K4's 8 warp totals, in place (lanes >= 8 of K4's warp 0 hold
// the identity and leave lanes < 8 alone)
template <class C>
SRK_HD void srk_tile_phase_c(float* w) {
  for (int d = 1; d < SRK_PLAY_WP; d <<= 1)
    for (int l = SRK_PLAY_WP - 1; l >= d; --l) w[l] = C::op(w[l - d], w[l]);
}

// a chunk's gate (and CV) tile of the CTA's VT voices, into `dst`
// ([lanes][VT][SRK_PLAY_ROW]); thread `tid` of `threads` (a multiple of VT)
template <int VT>
SRK_HD void srk_tile_fetch(const srk_tile_args& a, int r0, int t0, int tid,
                           int threads, float* dst) {
  const int cnt = a.n - t0 < SRK_SCAN_CHUNK ? a.n - t0 : SRK_SCAN_CHUNK;
  const int voices = a.rows - r0 < VT ? a.rows - r0 : VT;
  for (int lane_i = 0; lane_i < (a.cv ? 2 : 1); ++lane_i) {
    const float* src = lane_i ? a.cv : a.gate;
    const long long rs = lane_i ? a.c_rs : a.g_rs;
    const long long ts = lane_i ? a.c_ts : a.g_ts;
    float* d = dst + lane_i * VT * SRK_PLAY_ROW;
    if (ts != 1) {
      // neighbouring threads across voices, then along time: a time step's
      // voices are neighbouring words of the transposed [n, V] rows
      const int i = tid % VT;
      if (i >= voices) continue;
      const int step = threads / VT;
      const float* p = src + (size_t)(r0 + i) * rs + (size_t)t0 * ts;
      for (int t = tid / VT; t < cnt; t += step)
        srk_cp_async4(d + i * SRK_PLAY_ROW + t, p + (size_t)t * ts);
      continue;
    }
    const int done = a.vec ? cnt & ~3 : 0;
    for (int i = 0; i < voices; ++i) {  // along time, voice by voice
      const float* p = src + (size_t)(r0 + i) * rs + t0;
      float* di = d + i * SRK_PLAY_ROW;
      for (int t = 4 * tid; t < done; t += 4 * threads)
        srk_cp_async16(di + t, p + t);   // 16 bytes
      for (int t = done + tid; t < cnt; t += threads)
        srk_cp_async4(di + t, p + t);
    }
  }
}

#ifdef __CUDACC__

// the named barrier of one voice's NWV warps (ids from 1; 0 is
// __syncthreads)
template <int NWV>
__device__ __forceinline__ void srk_voice_barrier(int voice) {
  if (NWV == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + voice), "r"(NWV * 32)
                 : "memory");
  }
}

// a warp's share of one voice's chunk at t0: K4's warps sub * J ..
// sub * J + J - 1 (J = 8 / NWV).  gt, ct: the voice's tiles; tot: the
// voice's 8 warp totals of the sum, then of the max ([2][8]); carry: the
// chunk's carries, sum and max ([2][2], by chunk parity), written by the
// warp holding the chunk's last element
template <bool CV, int NWV>
__device__ __forceinline__ void srk_tile_chunk(
    const srk_tile_voice& p, int c, const float* gt, const float* ct,
    int voice, int sub, int lane, float* tot, float* carry,
    bool& prev_above, float* pos_end, int* playing_end,
    int* gate_last_end) {
  typedef srk_add<float> A;
  typedef srk_max<float> M;
  constexpr int J = SRK_PLAY_WP / NWV;
  const int t0 = c * SRK_SCAN_CHUNK;
  const bool last_warp = sub == NWV - 1;
  const float* cin = carry + ((c + 1) & 1) * 2;   // chunk c - 1's
  float* cout = carry + (c & 1) * 2;
  float cum[J][SRK_SCAN_ITEMS], m[J][SRK_SCAN_ITEMS], ex[J], w[SRK_PLAY_WP];
  // the sum: phases A and B of this warp's share, then C and D
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int e = (sub * J + j) * SRK_PLAY_WI + lane * SRK_SCAN_ITEMS;
#pragma unroll
    for (int k = 0; k < SRK_SCAN_ITEMS; ++k)
      cum[j][k] = p.sum_in<CV>(ct, e + k, t0 + e + k);
    if (CV) {
      srk_scan_fold<float, A>(cum[j]);
      const float t = srk_warp_scan<float, A>(cum[j][SRK_SCAN_ITEMS - 1],
                                              lane);
      const float x = srk_shfl_up(t, 1);
      ex[j] = lane == 0 ? A::id() : x;
      if (lane == 31) tot[sub * J + j] = t;
    }
  }
  if (CV) {
    srk_voice_barrier<NWV>(voice);
#pragma unroll
    for (int l = 0; l < SRK_PLAY_WP; ++l) w[l] = tot[l];
    srk_tile_phase_c<A>(w);
    const float c_sum = c == 0 ? A::id() : cin[0];
#pragma unroll
    for (int j = 0; j < J; ++j) {                                    // D
      const int wp = sub * J + j;
      const int e = wp * SRK_PLAY_WI + lane * SRK_SCAN_ITEMS;
      const float pw = wp == 0 ? A::id() : w[wp - 1];
#pragma unroll
      for (int k = 0; k < SRK_SCAN_ITEMS; ++k)
        cum[j][k] = A::op(c_sum, A::op(pw, A::op(ex[j], cum[j][k])));
      if (last_warp && j == J - 1 && lane == 31)
        cout[0] = cum[j][SRK_SCAN_ITEMS - 1];
#pragma unroll
      for (int k = 0; k < SRK_SCAN_ITEMS; ++k)
        cum[j][k] = cum[j][k] - p.rate<CV>(ct, e + k, t0 + e + k);
    }
  }
  // the fill: the marks, phases A and B, then C and D, and the output
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int e = (sub * J + j) * SRK_PLAY_WI + lane * SRK_SCAN_ITEMS;
#pragma unroll
    for (int k = 0; k < SRK_SCAN_ITEMS; ++k)
      m[j][k] = p.mark(gt, e + k, t0 + e + k, cum[j][k], prev_above);
    srk_scan_fold<float, M>(m[j]);
    const float t = srk_warp_scan<float, M>(m[j][SRK_SCAN_ITEMS - 1], lane);
    const float x = srk_shfl_up(t, 1);
    ex[j] = lane == 0 ? M::id() : x;
    if (lane == 31) tot[SRK_PLAY_WP + sub * J + j] = t;
  }
  srk_voice_barrier<NWV>(voice);
#pragma unroll
  for (int l = 0; l < SRK_PLAY_WP; ++l) w[l] = tot[SRK_PLAY_WP + l];
  srk_tile_phase_c<M>(w);
  const float c_max = c == 0 ? M::id() : cin[1];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int wp = sub * J + j;
    const int e = wp * SRK_PLAY_WI + lane * SRK_SCAN_ITEMS;
    const float pw = wp == 0 ? M::id() : w[wp - 1];
    float v[SRK_SCAN_ITEMS];
#pragma unroll
    for (int k = 0; k < SRK_SCAN_ITEMS; ++k) {
      const int i = t0 + e + k;
      const float mk = M::op(c_max, M::op(pw, M::op(ex[j], m[j][k])));
      if (last_warp && j == J - 1 && lane == 31 && k == SRK_SCAN_ITEMS - 1)
        cout[1] = mk;
      v[k] = i < p.n ? p.emit(i, cum[j][k], mk, p.rate<CV>(ct, e + k, i),
                              gt[e + k] > 0.0f, pos_end, playing_end,
                              gate_last_end)
                     : 0.0f;
    }
    const int i0 = t0 + e;
    if ((p.n & 3) == 0 && i0 < p.n) {
      *reinterpret_cast<float4*>(p.out + i0) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < SRK_SCAN_ITEMS; ++k)
        if (i0 + k < p.n) p.out[i0 + k] = v[k];
    }
  }
  prev_above = gt[SRK_SCAN_CHUNK - 1] > 0.0f;
}

// shared memory: the double-buffered tiles, then per voice its totals
// [2][8] and carries [2][2]
template <bool CV, int VT>
constexpr int srk_tile_floats() {
  return 2 * (CV ? 2 : 1) * VT * SRK_PLAY_ROW + VT * (2 * SRK_PLAY_WP + 4);
}

template <bool CV, int VT, int NWV>
__global__ void __launch_bounds__(32 * VT * NWV)
    srk_sample_play_tile_kernel(srk_tile_args a) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int voice = w / NWV, sub = w - voice * NWV;
  const int r0 = blockIdx.x * VT;
  const size_t r = (size_t)r0 + voice;
  const bool live = (int)r < a.rows;
  const int tile = (CV ? 2 : 1) * VT * SRK_PLAY_ROW;
  float* tot = sm + 2 * tile + voice * (2 * SRK_PLAY_WP + 4);
  float* carry = tot + 2 * SRK_PLAY_WP;
  const int n_chunks = (a.n + SRK_SCAN_CHUNK - 1) / SRK_SCAN_CHUNK;
  srk_tile_voice p;
  if (live) p.init(a, r);
  bool prev_above = live && p.last0 != 0;
  srk_tile_fetch<VT>(a, r0, 0, tid, blockDim.x, sm);
  srk_cp_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks)
      srk_tile_fetch<VT>(a, r0, (c + 1) * SRK_SCAN_CHUNK, tid, blockDim.x,
                         sm + ((c + 1) & 1) * tile);
    srk_cp_commit();
    srk_cp_wait1();
    __syncthreads();   // every thread's copies of chunk c have landed
    if (live) {
      const float* gt = sm + (c & 1) * tile + voice * SRK_PLAY_ROW;
      srk_tile_chunk<CV, NWV>(p, c, gt, gt + VT * SRK_PLAY_ROW, voice, sub,
                              lane, tot, carry, prev_above, a.pos_end + r,
                              a.playing_end + r, a.gate_last_end + r);
    }
    __syncthreads();   // before chunk c + 2 overwrites this buffer
  }
}

template <bool CV, int VT, int NWV>
static int srk_tile_launch_as(const srk_tile_args& a, void* stream) {
  const int blocks = (a.rows + VT - 1) / VT;
  const int bytes = srk_tile_floats<CV, VT>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      srk_sample_play_tile_kernel<CV, VT, NWV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  srk_sample_play_tile_kernel<CV, VT, NWV>
      <<<blocks, 32 * VT * NWV, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// the tile shapes (voices per CTA, warps per voice) a launch may take
#define SRK_TILE_SHAPES(X) X(0, 8, 1) X(1, 8, 2) X(2, 8, 4) X(3, 4, 8)

static int srk_tile_launch(const srk_tile_args& a, int shape, void* stream) {
  if (a.rows <= 0 || a.n <= 0) return (int)cudaGetLastError();
#define SRK_TILE_CASE(i, vt, nwv)                                        \
  case i:                                                                \
    return a.cv ? srk_tile_launch_as<true, vt, nwv>(a, stream)           \
                : srk_tile_launch_as<false, vt, nwv>(a, stream);
  switch (shape) {
    SRK_TILE_SHAPES(SRK_TILE_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SRK_TILE_CASE
}

#define SRK_TILE_RUN(a, shape) return srk_tile_launch(a, shape, stream)

#else  // the host build: the same phases over the 32 lanes' arrays

template <bool CV>
static void srk_tile_chunk_host(const srk_tile_voice& p, int t0,
                                const float* gt, const float* ct,
                                float& c_sum, float& c_max, bool& prev_above,
                                float* pos_end, int* playing_end,
                                int* gate_last_end) {
  typedef srk_add<float> A;
  typedef srk_max<float> M;
  static float cum[SRK_PLAY_WP][32][SRK_SCAN_ITEMS];
  static float m[SRK_PLAY_WP][32][SRK_SCAN_ITEMS];
  float ex[SRK_PLAY_WP][32], tot[SRK_PLAY_WP], t[32];
  for (int wp = 0; wp < SRK_PLAY_WP; ++wp) {
    for (int lane = 0; lane < 32; ++lane) {
      const int e = wp * SRK_PLAY_WI + lane * SRK_SCAN_ITEMS;
      for (int k = 0; k < SRK_SCAN_ITEMS; ++k)
        cum[wp][lane][k] = p.sum_in<CV>(ct, e + k, t0 + e + k);
      if (CV) srk_scan_fold<float, A>(cum[wp][lane]);
      t[lane] = cum[wp][lane][SRK_SCAN_ITEMS - 1];
    }
    if (CV) {
      for (int d = 1; d < 32; d <<= 1)
        for (int l = 31; l >= d; --l) t[l] = A::op(t[l - d], t[l]);
      ex[wp][0] = A::id();
      for (int l = 1; l < 32; ++l) ex[wp][l] = t[l - 1];
      tot[wp] = t[31];
    }
  }
  if (CV) {
    srk_tile_phase_c<A>(tot);
    for (int wp = 0; wp < SRK_PLAY_WP; ++wp) {
      const float pw = wp == 0 ? A::id() : tot[wp - 1];
      for (int lane = 0; lane < 32; ++lane)
        for (int k = 0; k < SRK_SCAN_ITEMS; ++k)
          cum[wp][lane][k] =
              A::op(c_sum, A::op(pw, A::op(ex[wp][lane], cum[wp][lane][k])));
    }
    c_sum = cum[SRK_PLAY_WP - 1][31][SRK_SCAN_ITEMS - 1];
    for (int wp = 0; wp < SRK_PLAY_WP; ++wp)
      for (int lane = 0; lane < 32; ++lane) {
        const int e = wp * SRK_PLAY_WI + lane * SRK_SCAN_ITEMS;
        for (int k = 0; k < SRK_SCAN_ITEMS; ++k)
          cum[wp][lane][k] =
              cum[wp][lane][k] - p.rate<CV>(ct, e + k, t0 + e + k);
      }
  }
  for (int wp = 0; wp < SRK_PLAY_WP; ++wp) {
    for (int lane = 0; lane < 32; ++lane) {
      const int e = wp * SRK_PLAY_WI + lane * SRK_SCAN_ITEMS;
      for (int k = 0; k < SRK_SCAN_ITEMS; ++k)
        m[wp][lane][k] =
            p.mark(gt, e + k, t0 + e + k, cum[wp][lane][k], prev_above);
      srk_scan_fold<float, M>(m[wp][lane]);
      t[lane] = m[wp][lane][SRK_SCAN_ITEMS - 1];
    }
    for (int d = 1; d < 32; d <<= 1)
      for (int l = 31; l >= d; --l) t[l] = M::op(t[l - d], t[l]);
    ex[wp][0] = M::id();
    for (int l = 1; l < 32; ++l) ex[wp][l] = t[l - 1];
    tot[wp] = t[31];
  }
  srk_tile_phase_c<M>(tot);
  float last = 0.0f;
  for (int wp = 0; wp < SRK_PLAY_WP; ++wp) {
    const float pw = wp == 0 ? M::id() : tot[wp - 1];
    for (int lane = 0; lane < 32; ++lane) {
      const int e = wp * SRK_PLAY_WI + lane * SRK_SCAN_ITEMS;
      for (int k = 0; k < SRK_SCAN_ITEMS; ++k) {
        const int i = t0 + e + k;
        const float mk =
            M::op(c_max, M::op(pw, M::op(ex[wp][lane], m[wp][lane][k])));
        last = mk;
        if (i < p.n)
          p.out[i] = p.emit(i, cum[wp][lane][k], mk,
                            p.rate<CV>(ct, e + k, i), gt[e + k] > 0.0f,
                            pos_end, playing_end, gate_last_end);
      }
    }
  }
  c_max = last;
  prev_above = gt[SRK_SCAN_CHUNK - 1] > 0.0f;
}

static int srk_tile_host(const srk_tile_args& a, int shape) {
  (void)shape;  // which warp runs which of K4's warps: no part of the order
  static float tile[2 * SRK_PLAY_VT * SRK_PLAY_ROW];
  const int n_chunks = (a.n + SRK_SCAN_CHUNK - 1) / SRK_SCAN_CHUNK;
  for (int r0 = 0; r0 < a.rows; r0 += SRK_PLAY_VT) {
    const int voices = a.rows - r0 < SRK_PLAY_VT ? a.rows - r0 : SRK_PLAY_VT;
    srk_tile_voice p[SRK_PLAY_VT];
    float c_sum[SRK_PLAY_VT], c_max[SRK_PLAY_VT];
    bool prev_above[SRK_PLAY_VT];
    for (int w = 0; w < voices; ++w) {
      p[w].init(a, (size_t)(r0 + w));
      c_sum[w] = srk_add<float>::id();
      c_max[w] = srk_max<float>::id();
      prev_above[w] = p[w].last0 != 0;
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int t0 = c * SRK_SCAN_CHUNK;
      for (int tid = 0; tid < 32 * SRK_PLAY_VT; ++tid)  // the card's threads
        srk_tile_fetch<SRK_PLAY_VT>(a, r0, t0, tid, 32 * SRK_PLAY_VT, tile);
      for (int w = 0; w < voices; ++w) {
        const float* gt = tile + w * SRK_PLAY_ROW;
        const float* ct = gt + SRK_PLAY_VT * SRK_PLAY_ROW;
        const size_t r = (size_t)(r0 + w);
        if (a.cv)
          srk_tile_chunk_host<true>(p[w], t0, gt, ct, c_sum[w], c_max[w],
                                    prev_above[w], a.pos_end + r,
                                    a.playing_end + r, a.gate_last_end + r);
        else
          srk_tile_chunk_host<false>(p[w], t0, gt, ct, c_sum[w], c_max[w],
                                     prev_above[w], a.pos_end + r,
                                     a.playing_end + r, a.gate_last_end + r);
      }
    }
  }
  return 0;
}

#define SRK_TILE_RUN(a, shape) return srk_tile_host(a, shape)

#endif

// -- the main path's entry --------------------------------------------------
//
// gate and cv (null: the constant-rate entry) are 2-D views read at
// base + row * rs + t * ts (strides in elements); the table and the per-row
// values contiguous; out [rows, n] contiguous.  vec = 1 asks for 16-byte
// copies along time: time strides 1, row strides a multiple of 4 and
// 16-byte aligned bases (the wrapper checks).

extern "C" int srk_sample_play(const float* gate, long long g_rs,
                               long long g_ts, const float* cv,
                               long long c_rs, long long c_ts,
                               const float* table, const float* base,
                               const float* pos0, const int* playing0,
                               const int* gate_last0, const int* length,
                               float* out, float* pos_end, int* playing_end,
                               int* gate_last_end, int rows, int n, int k,
                               int vec, int shape SRK_STREAM) {
  const srk_tile_args a{gate, g_rs, g_ts, cv, c_rs, c_ts, table, base, pos0,
                        playing0, gate_last0, length, out, pos_end,
                        playing_end, gate_last_end, rows, n, k, vec};
  SRK_TILE_RUN(a, shape);
}
