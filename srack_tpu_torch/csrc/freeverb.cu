// Freeverb: kernel K8 of srack_tpu_torch (ops/freeverb_kernel.py).
//
// Replaces srack_tpu/ops/freeverb_kernel.py::_build, the Pallas kernel that
// keeps a tile of 32 voices' 24 delay lines in VMEM and solves each comb's
// damping one-pole chunk by chunk with a log-doubling scan.  Both entries
// here run the exact ticks of the module's step
// (srack_tpu/modules/freeverb.py::_step), in its order: per channel 8
// lowpass-feedback combs summed from 0.0f in comb order, then 4 series
// allpasses; the input gain on the way in and the stereo wet/dry mix on the
// way out.  No damping scan, no tiers, no tail: an automated dampening or
// room_size reads its lane at each hold's start, t - t % chunk with chunk
// = the wrapper's shortest comb (the block form's piecewise-constant
// snapshot); wet, width and dry mix per sample.  Built with --fmad=false:
// every a*b+c rounds twice, as the torch step does.
//
// Layout (both entries).  The lines sit in device memory as [rows, V]: line
// j holds rows offs[j] .. offs[j] + lens[j] - 1, voice v in column v, combs
// left, right, then allpasses left, right.  The wrapper brings every ring
// into time order on entry (kernel K9), so every line starts at write
// index 0; on exit every line's write index is n % lens[j], and the
// wrapper's second K9 launch moves the lines back into [V, L] rings.
// The two input lanes are read in place through their own strides: each
// comes with a voice and a time stride in elements (arguments l_vs, l_ts,
// r_vs, r_ts after its pointer), sample t of voice v at lane[v * vs + t *
// ts].  The block engine's stage kernel K3 stores its output wires
// time-major, so the reverb's input lane is a [V, n] view with strides
// (1, V); a copy of it into rows took ~16 ms a render at 1,024 x 480,000,
// more than half K8's own time.  A contiguous lane reads at (n, 1), a
// broadcast at stride 0.  The gain lanes and the outputs stay contiguous
// [V, n] rows.
//
// srk_freeverb, the main path's kernel: one CTA per voice, its lines in
// shared memory.
//
// * Lines.  A CTA loads its voice's 24 lines (27,688 f32 at 48 kHz,
//   110,752 B) from its column of [rows, V] into shared memory once, runs
//   the whole render there and stores them back.  The column loads are
//   strided (one 4-byte word of each 32-byte sector), 8x sector
//   amplification on 113 MB at 1,024 voices, but neighbouring voices'
//   CTAs run at once and share the sectors in L2.  The 16 comb filter
//   states stay in registers.
// * Chunks.  Time goes in chunks of T samples, T at most the shortest of
//   the 24 lines (244 at 48 kHz, 24 at 4,800 Hz) and at most half the
//   shortest comb, and at least 8.  A line's slot is read again only a
//   line's length after its write, so within a chunk every comb read
//   y_j[t] = line_j[t] is a read of the past: the comb sum out = 0 + y_0
//   + ... + y_7 is parallel over t, and so is the allpass chain, each
//   stage reading its slot and then writing the same slot (distinct slots
//   per t).  One reader thread
//   per sample of the chunk (SRK_FV_TILE_MAX = 128 of them) computes both
//   channels' raw outputs, writes (l + r) * g for the combs into a double
//   buffer mix[2][T], and mixes the output lanes at once (the twin's
//   second pass, fused: no raw [2, V, n] round trip).
// * The serial work is each comb's damping one-pole, fsn = y*(1-dmp) +
//   f*dmp, line = mix + fsn*fd: 16 independent chains, one lane each of
//   one writer warp, each re-reading y from its slot before overwriting
//   it.  The writer runs one chunk behind the readers: at step k the
//   readers take chunk k and the writer chunk k - 1, and __syncthreads
//   ends the step.  The readers of chunk k then read comb slots the writer
//   of chunk k - 1 does not touch as long as 2T <= the shortest comb (the
//   wrapper's tile_for picks T so), and every slot they read was written
//   at step k - 1 or before.  A chain costs two dependent f32 operations per
//   sample (f*dmp, +).  The writer's 16 lanes wrap their lines at
//   different samples, so its control flow must not depend on the lane:
//   a run per lane up to its own wrap diverged in most chunks.  Here runs
//   of 16 samples wrap each slot by a select: 28.456 ms for the reverb
//   cell against the twin's 343.376 ms on the same operands
//   (chip_smoke.py phase 15, NVIDIA H100 80GB HBM3 at 700.00 W): 14.8 ns
//   per sample in each of the 4 waves, several times two dependent f32
//   operations' latency; what fills it is not measured (no profiler runs
//   on that card).
// * Bit for bit.  Every expression and its order are the twin's, so the
//   result equals the twin's bit for bit (tests/test_torch_block_host.py
//   on the host build; chip_smoke.py phase 15 on the card).
// * Shared memory and occupancy.  Per CTA 4 * (rows + 2T) bytes: 111,776 B
//   at 48 kHz (T = 128), plus the 1 KB the card reserves per CTA.  Two
//   CTAs fit an SM's 228 KB (2 x 112,800 = 225,600 B); three do not.  At
//   1,024 voices that is 1,024 CTAs on 264 slots: 3.9 waves.  A CTA per
//   voice and channel (56,824-58,024 B with its buffers and the reserve)
//   would fit 4 per SM: 2,048 CTAs on 528 slots, the same 3.9 waves, each
//   CTA as long (a writer warp issues the same instructions per sample for
//   8 chains as for 16).  The CTA per voice was chosen because it also
//   computes (l + r) * g once and fuses the mix pass, where a CTA per
//   channel cannot.  At 96 kHz a voice takes 222,584 B (one CTA per
//   SM; the 227 KB per-block limit is 232,448 B); at 192 kHz 443 KB does
//   not fit, and the wrapper takes the twin (ops/freeverb_kernel.py,
//   tile_for: a rule on the line lengths, never a fallback on an error).
// * Host build.  The same reader and writer functions run the same chunk
//   schedule in loops over one voice's buffer (readers of chunk k, then
//   the writer of chunk k - 1), so the CPU tests check the schedule.
//
// srk_freeverb_twin, the one-thread twin: one thread per voice and channel
// (2V threads, channel-major, one warp per block), each running the whole
// render with its lines in device memory, then srk_fv_mix_kernel mixes the
// two channels' raw outputs [2, V, n] elementwise.  Every sample loads and
// stores 12 line words; the 113 MB of lines of 1,024 voices at 48 kHz miss
// the 50 MB L2, so each sample waits about one device-memory latency
// (343.284 ms for the reverb cell, 1,024 x 480,000, on an NVIDIA H100
// 80GB HBM3 at 700.00 W: chip_smoke.py, PR 6's run).  It stays for the
// A/B of chip_smoke.py phase 15 and for lines too long for shared memory.
//
// The f64 build (entries srk_freeverb_f64, srk_freeverb_twin_f64): exact
// precision's core.  Every function below is a template on the core type
// C, float or double: the lines, the 16 comb filter states, the gains, the
// comb sums, the allpass chains, the mix and every constant on the way
// (0, 0.5, 1 as C) are C; the input lanes and the outputs stay f32, an
// input lane taken to C before the sum (l + r), an output rounded to f32
// once after the mix, as the module's f64 block form does.  A voice's
// lines take 8 * (rows + 2T) bytes: 223,552 B at 48 kHz (T = 128), one CTA
// per SM (the 227 KB per-block limit is 232,448 B), 1,024 CTAs in 7.8
// waves; at 96 kHz (445 KB) they do not fit and the wrapper's rule sends
// the voice to the f64 twin.  Shared-memory banks: a reader warp reads 32
// consecutive doubles of one line (256 B, two wavefronts, no conflict);
// the writer warp's 16 comb lanes each read and write one double of its
// own line, at offsets as scattered as the f32 build's words, two banks
// each.
//
// What bounds K8: the bytes it must move are its lanes in and out and the
// lines and filter states in and out once (1.828 ms at 3.35 TB/s for the
// stereo reverb cell); its f32 operations (132 per voice-sample) take
// 0.97 ms at 67 TFLOP/s.  Neither is near: the serial chains are, 480,000
// samples in each of 3.9 waves.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SRK_HD __host__ __device__ __forceinline__
#else
#include <vector>
#define SRK_HD inline
#endif

#define SRK_FV_COMBS 8    // per channel
#define SRK_FV_PASSES 4   // allpasses per channel
#define SRK_FV_LINES 12   // per channel
#define SRK_FV_ALL 24     // lines per voice
#define SRK_FV_FS 16      // comb filter states per voice: cl0..7, cr0..7
#define SRK_FV_BLOCK 32
#define SRK_FV_MIX_BLOCK 256
#define SRK_FV_TILE_MAX 128  // reader threads: the longest chunk T
#define SRK_FV_TILE_MIN 8    // the writer's runs of 16 need combs >= 16 long
#define SRK_FV_THREADS (SRK_FV_TILE_MAX + 32)  // and one writer warp

// A sample's input lanes and output gains: l, r (a missing input lane is
// 0; f32 lanes) and wet1, wet2, dry (per voice, [V], or a lane, [V, n]; in
// the core type C).
template <typename C>
struct srk_fv_in {
  float l, r;
  C w1, w2, d;
};

// An input lane is read where it lies: sample t of voice v at
// lane[v * vs + t * ts], each lane with its own strides in elements (K3's
// time-major stage output gives (1, V), a contiguous lane (n, 1), a
// broadcast 0); offsets in 64 bits, past 2^31 at 16,384 x 480,000.
#define SRK_FV_LANES                                                        \
  const float *l_in, long long l_vs, long long l_ts, const float *r_in,    \
      long long r_vs, long long r_ts
#define SRK_FV_LANES_CALL l_in, l_vs, l_ts, r_in, r_vs, r_ts
#define SRK_FV_IN_PARAMS                                                    \
  SRK_FV_LANES, const C *wet1, int wet1_lane, const C *wet2, int wet2_lane, \
      const C *dry, int dry_lane
#define SRK_FV_IN_ARGS \
  SRK_FV_LANES_CALL, wet1, wet1_lane, wet2, wet2_lane, dry, dry_lane

SRK_HD float srk_fv_lane_at(const float* x, long long vs, long long ts,
                            long long v, long long t) {
  return x ? x[v * vs + t * ts] : 0.0f;
}

// sample t of voice v; i = v * n + t, its element of the [V, n] gain lanes
// and outputs.  A mono voice's one lane (r the same pointer and strides as
// l) is loaded once: from a time-major lane each load of a reader warp
// touches 32 sectors, and the second load of the same words cost K8 ~1 ms
// a reverb render (K8 alone on the operands a 1,024 x 480,000 reverb render
// gives it, NVIDIA H100 80GB HBM3 at 700.00 W: 29.61 ms with two loads,
// 28.65 with one, 27.49 from a contiguous copy).
template <typename C>
SRK_HD srk_fv_in<C> srk_fv_in_at(size_t i, size_t v, size_t t,
                                 SRK_FV_IN_PARAMS) {
  srk_fv_in<C> x;
  x.l = srk_fv_lane_at(l_in, l_vs, l_ts, (long long)v, (long long)t);
  x.r = r_in == l_in && r_vs == l_vs && r_ts == l_ts
            ? x.l
            : srk_fv_lane_at(r_in, r_vs, r_ts, (long long)v, (long long)t);
  x.w1 = wet1[wet1_lane ? i : v];
  x.w2 = wet2[wet2_lane ? i : v];
  x.d = dry[dry_lane ? i : v];
  return x;
}

// The output mix of element i from the channels' raw outputs: the same
// expressions, in the same order, as the module's block form, in C, then
// rounded to f32 once.
template <typename C>
SRK_HD void srk_fv_mix_out(size_t i, const srk_fv_in<C>& x, C rl, C rr,
                           float* out_l, float* out_r) {
  out_l[i] = (float)(rl * x.w1 + rr * x.w2 + (C)x.l * x.d);
  if (out_r) out_r[i] = (float)(rr * x.w1 + rl * x.w2 + (C)x.r * x.d);
}

// the entries' arguments for the core type C (float or double)
#define SRK_FV_ARGS_T(C)                                                    \
  SRK_FV_LANES, const C *damp, int damp_lane, const C *feed, int feed_lane, \
      const C *in_gain, const C *wet1, int wet1_lane, const C *wet2,        \
      int wet2_lane, const C *dry, int dry_lane, C *fs, C *lines,           \
      const int *lens, const int *offs, C *raw, float *out_l, float *out_r, \
      int V, int n, int chunk
#define SRK_FV_ARGS SRK_FV_ARGS_T(C)
#define SRK_FV_CALL                                                         \
  SRK_FV_LANES_CALL, damp, damp_lane, feed, feed_lane, in_gain, wet1,       \
      wet1_lane, wet2, wet2_lane, dry, dry_lane, fs, lines, lens, offs, raw, \
      out_l, out_r, V, n, chunk

// -- srk_freeverb: one CTA per voice, lines in shared memory -----------------

// A reader's view of the lines: each line's length, its offset in the
// voice's buffer and the write index of the chunk's first sample.
struct srk_fv_taps {
  int len[SRK_FV_ALL], off[SRK_FV_ALL], pos[SRK_FV_ALL];
};

SRK_HD void srk_fv_taps_init(srk_fv_taps& L, const int* lens,
                             const int* offs) {
#pragma unroll
  for (int j = 0; j < SRK_FV_ALL; ++j) {
    L.len[j] = lens[j];
    L.off[j] = offs[j];
    L.pos[j] = 0;
  }
}

// the next chunk's write indices (T <= every line's length)
SRK_HD void srk_fv_taps_next(srk_fv_taps& L, int T) {
#pragma unroll
  for (int j = 0; j < SRK_FV_ALL; ++j) {
    L.pos[j] += T;
    if (L.pos[j] >= L.len[j]) L.pos[j] -= L.len[j];
  }
}

// Sample i = row + t0 + tc of voice v, its inputs x: both channels' comb
// reads and allpass chains in the voice's buffer sm, the combs' input
// into mix[tc] and the output mix.
template <typename C>
SRK_HD void srk_fv_tile_read(const srk_fv_taps& L, int tc, size_t i,
                             const srk_fv_in<C>& x, C g, C* sm, C* mix,
                             float* out_l, float* out_r) {
  mix[tc] = ((C)x.l + (C)x.r) * g;
  C raw_out[2];
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    C out = (C)0;
#pragma unroll
    for (int j = 0; j < SRK_FV_COMBS; ++j) {
      const int k = ch * SRK_FV_COMBS + j;
      int s = L.pos[k] + tc;
      if (s >= L.len[k]) s -= L.len[k];
      out = out + sm[L.off[k] + s];
    }
#pragma unroll
    for (int a = 0; a < SRK_FV_PASSES; ++a) {
      const int k = 2 * SRK_FV_COMBS + ch * SRK_FV_PASSES + a;
      int s = L.pos[k] + tc;
      if (s >= L.len[k]) s -= L.len[k];
      C* slot = sm + L.off[k] + s;
      const C delayed = *slot;
      const C o = delayed - out;
      *slot = out + delayed * (C)0.5;
      out = o;
    }
    raw_out[ch] = out;
  }
  srk_fv_mix_out(i, x, raw_out[0], raw_out[1], out_l, out_r);
}

// One comb's serial state: a writer lane.
template <typename C>
struct srk_fv_comb {
  C f;              // the damping one-pole's state
  C dmp, omd, fd;   // dampening, 1 - dampening, feedback
  int p;            // the write index of the next sample
  int next;         // the next sample at which the damp/feed lanes are read
};

template <typename C>
SRK_HD void srk_fv_comb_init(srk_fv_comb<C>& K, const C* fs0, const C* damp,
                             int damp_lane, const C* feed, int feed_lane,
                             size_t v) {
  K.f = *fs0;
  K.dmp = damp_lane ? (C)0 : damp[v];
  K.omd = (C)1 - K.dmp;
  K.fd = feed_lane ? (C)0 : feed[v];
  K.p = 0;
  K.next = 0;
}

// Samples t0 .. t0 + cnt - 1 of one comb (line of length len >= 16 in the
// voice's buffer), its input in mix[0 .. cnt - 1]: the twin's damping
// one-pole and line write.  The 16 combs of a voice run in one warp, so
// the control flow is the same in every lane: runs end only at a hold's
// start (the same sample for every comb) or the chunk's end, and a line's
// wrap is a select per sample.  Sixteen samples' loads go ahead of their
// chain, so the chain waits on shared memory once per sixteen samples.
template <typename C>
SRK_HD void srk_fv_tile_comb(srk_fv_comb<C>& K, C* line, int len,
                             const C* mix, int t0, int cnt, size_t row,
                             const C* damp, int damp_lane, const C* feed,
                             int feed_lane, int chunk) {
  int tc = 0;
  while (tc < cnt) {
    const int t = t0 + tc;
    if (t == K.next) {  // the lanes' snapshot at each hold's start
      if (damp_lane) K.dmp = damp[row + t];
      if (feed_lane) K.fd = feed[row + t];
      K.omd = (C)1 - K.dmp;
      K.next += chunk;
    }
    int seg = cnt - tc;
    if (seg > K.next - t) seg = K.next - t;
    const C* m = mix + tc;
    int i = 0;
    for (; i + 16 <= seg; i += 16) {
      int q[16];
      C y[16], x[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        q[u] = K.p + u;
        if (q[u] >= len) q[u] -= len;
        y[u] = line[q[u]];
        x[u] = m[i + u];
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const C fsn = y[u] * K.omd + K.f * K.dmp;
        K.f = fsn;
        y[u] = x[u] + fsn * K.fd;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) line[q[u]] = y[u];
      K.p += 16;
      if (K.p >= len) K.p -= len;
    }
    for (; i < seg; ++i) {
      const C fsn = line[K.p] * K.omd + K.f * K.dmp;
      K.f = fsn;
      line[K.p] = m[i] + fsn * K.fd;
      if (++K.p == len) K.p = 0;
    }
    tc += seg;
  }
}

// -- srk_freeverb_twin: one thread per voice and channel ---------------------

// One voice and channel over the whole render.  Lines: combs c<ch>0..7
// are lines ch*8 + j, allpasses a<ch>0..3 are lines 16 + ch*4 + a.
template <typename C>
SRK_HD void srk_fv_voice(int v, int ch, int V, int n, int chunk,
                         SRK_FV_LANES, const C* damp, int damp_lane,
                         const C* feed, int feed_lane, const C* in_gain,
                         C* fs, C* lines, const int* lens, const int* offs,
                         C* raw) {
  C* line[SRK_FV_LINES];
  int len[SRK_FV_LINES], idx[SRK_FV_LINES];
  for (int j = 0; j < SRK_FV_LINES; ++j) {
    const int k = j < SRK_FV_COMBS ? ch * SRK_FV_COMBS + j
                                   : 16 + ch * SRK_FV_PASSES +
                                         (j - SRK_FV_COMBS);
    line[j] = lines + (size_t)offs[k] * V + v;
    len[j] = lens[k];
    idx[j] = 0;
  }
  C f[SRK_FV_COMBS];
  for (int j = 0; j < SRK_FV_COMBS; ++j)
    f[j] = fs[(size_t)v * SRK_FV_FS + ch * SRK_FV_COMBS + j];
  const C g = in_gain[v];
  const size_t row = (size_t)v * n;
  C dmp = damp_lane ? (C)0 : damp[v];
  C fd = feed_lane ? (C)0 : feed[v];
  C* out_row = raw + ((size_t)ch * V + v) * n;
  for (int t = 0; t < n; ++t) {
    if (t % chunk == 0) {  // the lanes' snapshot at each chunk's start
      if (damp_lane) dmp = damp[row + t];
      if (feed_lane) fd = feed[row + t];
    }
    const C l = (C)srk_fv_lane_at(l_in, l_vs, l_ts, v, t);
    const C r = (C)srk_fv_lane_at(r_in, r_vs, r_ts, v, t);
    const C mixed = (l + r) * g;
    C y[SRK_FV_LINES];
#pragma unroll
    for (int j = 0; j < SRK_FV_LINES; ++j)
      y[j] = line[j][(size_t)idx[j] * V];
    C out = (C)0;
#pragma unroll
    for (int j = 0; j < SRK_FV_COMBS; ++j) {
      const C fsn = y[j] * ((C)1 - dmp) + f[j] * dmp;
      f[j] = fsn;
      line[j][(size_t)idx[j] * V] = mixed + fsn * fd;
      out = out + y[j];
    }
#pragma unroll
    for (int a = SRK_FV_COMBS; a < SRK_FV_LINES; ++a) {
      const C delayed = y[a];
      const C o = delayed - out;
      line[a][(size_t)idx[a] * V] = out + delayed * (C)0.5;
      out = o;
    }
    out_row[t] = out;
#pragma unroll
    for (int j = 0; j < SRK_FV_LINES; ++j)
      if (++idx[j] == len[j]) idx[j] = 0;
  }
  for (int j = 0; j < SRK_FV_COMBS; ++j)
    fs[(size_t)v * SRK_FV_FS + ch * SRK_FV_COMBS + j] = f[j];
}

// The twin's second pass, element i of [V, n].
template <typename C>
SRK_HD void srk_fv_mix(size_t i, int V, int n, const C* raw,
                       SRK_FV_IN_PARAMS, float* out_l, float* out_r) {
  const size_t v = i / (size_t)n;
  srk_fv_mix_out<C>(i, srk_fv_in_at<C>(i, v, i - v * n, SRK_FV_IN_ARGS),
                    raw[i], raw[(size_t)V * n + i], out_l, out_r);
}

#ifdef __CUDACC__

template <typename C>
__global__ void __launch_bounds__(SRK_FV_THREADS, 2)
    srk_fv_tile_kernel(SRK_FV_ARGS, int rows, int T) {
  extern __shared__ __align__(16) unsigned char srk_fv_smem[];
  C* sm = reinterpret_cast<C*>(srk_fv_smem);
  C* mix = sm + rows;   // [2][T]
  const int v = blockIdx.x;
  const int tid = threadIdx.x;
  for (int r = tid; r < rows; r += SRK_FV_THREADS)
    sm[r] = lines[(size_t)r * V + v];
  __syncthreads();
  const size_t row = (size_t)v * n;
  const int n_chunks = (n + T - 1) / T;
  if (tid < SRK_FV_TILE_MAX) {
    // a reader: sample t0 + tid of each chunk, its inputs loaded during
    // the chunk before (a device-memory wait per chunk would otherwise
    // set the step's length).  From a time-major lane (time stride V) the
    // 128 readers touch 128 sectors a chunk where rows take 16; the
    // co-resident CTAs hold neighbouring voices, which share them in L2.
    // Staging the next chunk in shared memory with cp.async instead was
    // no faster on the same operands (29.73 ms against 28.65).
    srk_fv_taps L;
    srk_fv_taps_init(L, lens, offs);
    const C g = in_gain[v];
    srk_fv_in<C> x = {};
    if (tid < T && tid < n)
      x = srk_fv_in_at<C>(row + tid, v, tid, SRK_FV_IN_ARGS);
    for (int k = 0; k <= n_chunks; ++k) {
      const int t = k * T + tid;
      const bool mine = k < n_chunks && tid < T && t < n;
      const srk_fv_in<C> cur = x;
      if (tid < T && t + T < n)
        x = srk_fv_in_at<C>(row + t + T, v, t + T, SRK_FV_IN_ARGS);
      if (mine)
        srk_fv_tile_read<C>(L, tid, row + t, cur, g, sm, mix + (k & 1) * T,
                            out_l, out_r);
      srk_fv_taps_next(L, T);
      __syncwarp();
      __syncthreads();
    }
  } else {
    // the writer warp: lane c < 16 runs comb c (channel c / 8) one chunk
    // behind the readers
    const int c = tid - SRK_FV_TILE_MAX;
    const bool live = c < SRK_FV_FS;
    srk_fv_comb<C> K;
    int len = 1;
    C* line = sm;
    if (live) {
      srk_fv_comb_init<C>(K, fs + (size_t)v * SRK_FV_FS + c, damp,
                          damp_lane, feed, feed_lane, v);
      len = lens[c];
      line = sm + offs[c];
    }
    for (int k = 0; k <= n_chunks; ++k) {
      const int t0 = (k - 1) * T;
      if (live && k > 0)
        srk_fv_tile_comb<C>(K, line, len, mix + ((k - 1) & 1) * T, t0,
                            n - t0 < T ? n - t0 : T, row, damp, damp_lane,
                            feed, feed_lane, chunk);
      __syncwarp();
      __syncthreads();
    }
    if (live) fs[(size_t)v * SRK_FV_FS + c] = K.f;
  }
  __syncthreads();
  for (int r = tid; r < rows; r += SRK_FV_THREADS)
    lines[(size_t)r * V + v] = sm[r];
}

template <typename C>
__global__ void __launch_bounds__(SRK_FV_BLOCK)
    srk_fv_kernel(SRK_FV_LANES, const C* damp, int damp_lane, const C* feed,
                  int feed_lane, const C* in_gain, C* fs, C* lines,
                  const int* lens, const int* offs, C* raw, int V, int n,
                  int chunk) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= 2 * V) return;
  const int ch = g / V, v = g - ch * V;
  srk_fv_voice<C>(v, ch, V, n, chunk, SRK_FV_LANES_CALL, damp, damp_lane,
                  feed, feed_lane, in_gain, fs, lines, lens, offs, raw);
}

template <typename C>
__global__ void __launch_bounds__(SRK_FV_MIX_BLOCK)
    srk_fv_mix_kernel(int V, int n, const C* raw, SRK_FV_IN_PARAMS,
                      float* out_l, float* out_r) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)V * n) return;
  srk_fv_mix<C>(i, V, n, raw, SRK_FV_IN_ARGS, out_l, out_r);
}

template <typename C>
static size_t srk_fv_tile_bytes(int rows, int T) {
  return sizeof(C) * ((size_t)rows + 2 * (size_t)T);
}

template <typename C>
static cudaError_t srk_fv_tile_attrs(size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      srk_fv_tile_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(srk_fv_tile_kernel<C>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// rows: the lines' rows (sum of lens); T: the chunk, SRK_FV_TILE_MIN <= T
// <= SRK_FV_TILE_MAX, at most every line's length and half the shortest
// comb's (the wrapper's tile_for).  raw is not used.
template <typename C>
static int srk_freeverb_run(SRK_FV_ARGS, int rows, int T, void* stream) {
  if (V <= 0 || n <= 0) return 0;
  if (T < SRK_FV_TILE_MIN || T > SRK_FV_TILE_MAX || rows < 1)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = srk_fv_tile_bytes<C>(rows, T);
  cudaError_t err = srk_fv_tile_attrs<C>(bytes);
  if (err != cudaSuccess) return (int)err;
  srk_fv_tile_kernel<C><<<V, SRK_FV_THREADS, bytes, (cudaStream_t)stream>>>(
      SRK_FV_CALL, rows, T);
  return (int)cudaGetLastError();
}

// CTAs of srk_freeverb resident on one SM at these rows and T (into
// *ctas); the smoke run logs it beside the source note's arithmetic.
template <typename C>
static int srk_freeverb_ctas(int rows, int T, int* ctas) {
  const size_t bytes = srk_fv_tile_bytes<C>(rows, T);
  cudaError_t err = srk_fv_tile_attrs<C>(bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, srk_fv_tile_kernel<C>, SRK_FV_THREADS, bytes);
}

template <typename C>
static int srk_freeverb_twin_run(SRK_FV_ARGS, void* stream) {
  if (V <= 0 || n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  srk_fv_kernel<C><<<(2 * V + SRK_FV_BLOCK - 1) / SRK_FV_BLOCK,
                     SRK_FV_BLOCK, 0, s>>>(SRK_FV_LANES_CALL, damp,
                                           damp_lane, feed, feed_lane,
                                           in_gain, fs, lines, lens, offs,
                                           raw, V, n, chunk);
  const size_t total = (size_t)V * n;
  srk_fv_mix_kernel<C><<<(unsigned)((total + SRK_FV_MIX_BLOCK - 1) /
                                    SRK_FV_MIX_BLOCK),
                         SRK_FV_MIX_BLOCK, 0, s>>>(
      V, n, raw, SRK_FV_IN_ARGS, out_l, out_r);
  return (int)cudaGetLastError();
}

#define SRK_FV_STREAM , void* stream
#define SRK_FV_PASS_STREAM , stream

#else

// The card's schedule on the host: per voice its buffer, then at step k
// the readers of chunk k and the writer of chunk k - 1.
template <typename C>
static int srk_freeverb_run(SRK_FV_ARGS, int rows, int T) {
  if (V <= 0 || n <= 0) return 0;
  if (T < SRK_FV_TILE_MIN || T > SRK_FV_TILE_MAX || rows < 1) return 1;
  std::vector<C> buf((size_t)rows + 2 * (size_t)T);
  C* sm = buf.data();
  C* mix = sm + rows;
  const int n_chunks = (n + T - 1) / T;
  for (int v = 0; v < V; ++v) {
    for (int r = 0; r < rows; ++r) sm[r] = lines[(size_t)r * V + v];
    const size_t row = (size_t)v * n;
    srk_fv_taps L;
    srk_fv_taps_init(L, lens, offs);
    srk_fv_comb<C> K[SRK_FV_FS];
    for (int c = 0; c < SRK_FV_FS; ++c)
      srk_fv_comb_init<C>(K[c], fs + (size_t)v * SRK_FV_FS + c, damp,
                          damp_lane, feed, feed_lane, v);
    for (int k = 0; k <= n_chunks; ++k) {
      const int t0 = k * T;
      for (int tc = 0; k < n_chunks && tc < T && t0 + tc < n; ++tc)
        srk_fv_tile_read<C>(L, tc, row + t0 + tc,
                            srk_fv_in_at<C>(row + t0 + tc, v, t0 + tc,
                                            SRK_FV_IN_ARGS),
                            in_gain[v], sm, mix + (k & 1) * T, out_l, out_r);
      srk_fv_taps_next(L, T);
      if (k == 0) continue;
      const int w0 = t0 - T;
      for (int c = 0; c < SRK_FV_FS; ++c)
        srk_fv_tile_comb<C>(K[c], sm + offs[c], lens[c],
                            mix + ((k - 1) & 1) * T, w0,
                            n - w0 < T ? n - w0 : T, row, damp, damp_lane,
                            feed, feed_lane, chunk);
    }
    for (int c = 0; c < SRK_FV_FS; ++c)
      fs[(size_t)v * SRK_FV_FS + c] = K[c].f;
    for (int r = 0; r < rows; ++r) lines[(size_t)r * V + v] = sm[r];
  }
  return 0;
}

template <typename C>
static int srk_freeverb_twin_run(SRK_FV_ARGS) {
  for (int ch = 0; ch < 2; ++ch)
    for (int v = 0; v < V; ++v)
      srk_fv_voice<C>(v, ch, V, n, chunk, SRK_FV_LANES_CALL, damp,
                      damp_lane, feed, feed_lane, in_gain, fs, lines, lens,
                      offs, raw);
  for (size_t i = 0; i < (size_t)V * n; ++i)
    srk_fv_mix<C>(i, V, n, raw, SRK_FV_IN_ARGS, out_l, out_r);
  return 0;
}

#define SRK_FV_STREAM
#define SRK_FV_PASS_STREAM

#endif

// -- entry points: f32 and f64 cores (the host build takes no stream) -----

#undef SRK_FV_ARGS
#define SRK_FV_ENTRIES(C, SUFFIX)                                           \
  extern "C" int srk_freeverb##SUFFIX(SRK_FV_ARGS_T(C), int rows,           \
                                      int T SRK_FV_STREAM) {                \
    return srk_freeverb_run<C>(SRK_FV_CALL, rows, T SRK_FV_PASS_STREAM);    \
  }                                                                         \
  extern "C" int srk_freeverb_twin##SUFFIX(SRK_FV_ARGS_T(C)                 \
                                               SRK_FV_STREAM) {             \
    return srk_freeverb_twin_run<C>(SRK_FV_CALL SRK_FV_PASS_STREAM);        \
  }

SRK_FV_ENTRIES(float, )
SRK_FV_ENTRIES(double, _f64)

#ifdef __CUDACC__
extern "C" int srk_freeverb_ctas_per_sm(int rows, int T, int* ctas) {
  return srk_freeverb_ctas<float>(rows, T, ctas);
}

extern "C" int srk_freeverb_ctas_per_sm_f64(int rows, int T, int* ctas) {
  return srk_freeverb_ctas<double>(rows, T, ctas);
}
#endif
