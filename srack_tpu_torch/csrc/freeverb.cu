// Freeverb: kernel K8 of srack_tpu_torch (ops/freeverb_kernel.py).
//
// Replaces srack_tpu/ops/freeverb_kernel.py::_build, the Pallas kernel that
// keeps a tile of 32 voices' 24 delay lines in VMEM and solves each comb's
// damping one-pole chunk by chunk with a log-doubling scan.  This kernel
// runs the exact per-sample ticks of the module's step
// (srack_tpu/modules/freeverb.py::_step): per channel 8 lowpass-feedback
// combs summed, then 4 series allpasses; the input gain on the way in and
// the stereo wet/dry mix on the way out.  No chunks, no damping tiers, no
// tail: an automated dampening or room_size reads its lane at each chunk's
// start, t - t % chunk with chunk = the shortest comb (the block form's
// piecewise-constant snapshot); wet, width and dry mix per sample.
//
// Launch shape.  srk_fv_kernel: one thread per voice and channel (2V
// threads, channel-major, one warp per block), each running the whole
// render with its 8 comb filter states in registers; srk_fv_mix_kernel: a
// second, elementwise pass over [V, n] that mixes the two channels' raw
// outputs (final_l = raw_l*wet1 + raw_r*wet2 + l_in*dry), which one
// channel's thread cannot do alone.
//
// Layout.  The lines sit in device memory as [rows, V]: line j holds rows
// offs[j] .. offs[j] + lens[j] - 1, voice v in column v.  The wrapper
// brings every ring into time order on entry (kernel K9, which writes this
// layout from the module's [V, L] rings), so every line of
// every voice starts at write index 0 and at sample t a warp's 32 voices
// touch 32 neighbouring floats of one row: 128 contiguous bytes.  On exit
// every line's write index is n % lens[j], and the wrapper's second K9
// launch moves the lines back into [V, L] rings, in time order with index 0.
//
// What bounds it, and the open design question.  The bytes that the
// function must move are its lanes: the inputs, the outputs and the raw
// outputs, 3 lanes of [V, n] f32 in and out, 5.9 GB at 1,024 voices x
// 480,000 samples (1.8 ms at 3.35 TB/s).  This per-sample design also
// reads and writes each line word once per sample: 24 lines x V x 8 bytes
// per sample, 94 GB for that render.  The lines of 1,024 voices at 48 kHz
// are 108 MiB, more than the 50 MB L2, and a word comes back only after a
// whole line's length of samples, so those accesses go to device memory,
// and with 2V threads in flight the kernel waits on their latency.  The
// design that answers it is a CTA per voice with that voice's 108 KiB of
// lines in shared memory and the combs solved chunk-parallel (the damping
// one-pole as a scan, as the TPU kernel does): a later change.  To hide
// some latency now, each sample issues its 12 line loads before any of its
// stores (every load reads a word written at least one line length ago).
//
// Built with --fmad=false: every a*b+c rounds twice, as the torch step
// does, so the kernel equals the scan engine's per-sample step.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SRK_HD __host__ __device__ __forceinline__
#else
#define SRK_HD inline
#endif

#define SRK_FV_COMBS 8    // per channel
#define SRK_FV_PASSES 4   // allpasses per channel
#define SRK_FV_LINES 12   // per channel
#define SRK_FV_FS 16      // comb filter states per voice: cl0..7, cr0..7
#define SRK_FV_BLOCK 32
#define SRK_FV_MIX_BLOCK 256

// One voice and channel over the whole render.  Lines: combs c<ch>0..7
// are lines ch*8 + j, allpasses a<ch>0..3 are lines 16 + ch*4 + a.
SRK_HD void srk_fv_voice(int v, int ch, int V, int n, int chunk,
                         const float* l_in, const float* r_in,
                         const float* damp, int damp_lane,
                         const float* feed, int feed_lane,
                         const float* in_gain, float* fs, float* lines,
                         const int* lens, const int* offs, float* raw) {
  float* line[SRK_FV_LINES];
  int len[SRK_FV_LINES], idx[SRK_FV_LINES];
  for (int j = 0; j < SRK_FV_LINES; ++j) {
    const int k = j < SRK_FV_COMBS ? ch * SRK_FV_COMBS + j
                                   : 16 + ch * SRK_FV_PASSES +
                                         (j - SRK_FV_COMBS);
    line[j] = lines + (size_t)offs[k] * V + v;
    len[j] = lens[k];
    idx[j] = 0;
  }
  float f[SRK_FV_COMBS];
  for (int j = 0; j < SRK_FV_COMBS; ++j)
    f[j] = fs[(size_t)v * SRK_FV_FS + ch * SRK_FV_COMBS + j];
  const float g = in_gain[v];
  const size_t row = (size_t)v * n;
  float dmp = damp_lane ? 0.0f : damp[v];
  float fd = feed_lane ? 0.0f : feed[v];
  float* out_row = raw + ((size_t)ch * V + v) * n;
  for (int t = 0; t < n; ++t) {
    if (t % chunk == 0) {  // the lanes' snapshot at each chunk's start
      if (damp_lane) dmp = damp[row + t];
      if (feed_lane) fd = feed[row + t];
    }
    const float l = l_in ? l_in[row + t] : 0.0f;
    const float r = r_in ? r_in[row + t] : 0.0f;
    const float mixed = (l + r) * g;
    float y[SRK_FV_LINES];
#pragma unroll
    for (int j = 0; j < SRK_FV_LINES; ++j)
      y[j] = line[j][(size_t)idx[j] * V];
    float out = 0.0f;
#pragma unroll
    for (int j = 0; j < SRK_FV_COMBS; ++j) {
      const float fsn = y[j] * (1.0f - dmp) + f[j] * dmp;
      f[j] = fsn;
      line[j][(size_t)idx[j] * V] = mixed + fsn * fd;
      out = out + y[j];
    }
#pragma unroll
    for (int a = SRK_FV_COMBS; a < SRK_FV_LINES; ++a) {
      const float delayed = y[a];
      const float o = delayed - out;
      line[a][(size_t)idx[a] * V] = out + delayed * 0.5f;
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

// The output mix of element i of [V, n]: the same expressions, in the same
// order, as the module's block form.  A gain is per voice ([V]) or a lane
// ([V, n]); a missing input lane is 0.
SRK_HD void srk_fv_mix(size_t i, int V, int n, const float* raw,
                       const float* l_in, const float* r_in,
                       const float* wet1, int wet1_lane, const float* wet2,
                       int wet2_lane, const float* dry, int dry_lane,
                       float* out_l, float* out_r) {
  const size_t v = i / (size_t)n;
  const float rl = raw[i], rr = raw[(size_t)V * n + i];
  const float w1 = wet1[wet1_lane ? i : v];
  const float w2 = wet2[wet2_lane ? i : v];
  const float d = dry[dry_lane ? i : v];
  const float l = l_in ? l_in[i] : 0.0f;
  const float r = r_in ? r_in[i] : 0.0f;
  out_l[i] = rl * w1 + rr * w2 + l * d;
  if (out_r) out_r[i] = rr * w1 + rl * w2 + r * d;
}

#define SRK_FV_ARGS                                                         \
  const float *l_in, const float *r_in, const float *damp, int damp_lane,   \
      const float *feed, int feed_lane, const float *in_gain,               \
      const float *wet1, int wet1_lane, const float *wet2, int wet2_lane,   \
      const float *dry, int dry_lane, float *fs, float *lines,              \
      const int *lens, const int *offs, float *raw, float *out_l,           \
      float *out_r, int V, int n, int chunk

#ifdef __CUDACC__

__global__ void __launch_bounds__(SRK_FV_BLOCK)
    srk_fv_kernel(const float* l_in, const float* r_in, const float* damp,
                  int damp_lane, const float* feed, int feed_lane,
                  const float* in_gain, float* fs, float* lines,
                  const int* lens, const int* offs, float* raw, int V, int n,
                  int chunk) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= 2 * V) return;
  const int ch = g / V, v = g - ch * V;
  srk_fv_voice(v, ch, V, n, chunk, l_in, r_in, damp, damp_lane, feed,
               feed_lane, in_gain, fs, lines, lens, offs, raw);
}

__global__ void __launch_bounds__(SRK_FV_MIX_BLOCK)
    srk_fv_mix_kernel(int V, int n, const float* raw, const float* l_in,
                      const float* r_in, const float* wet1, int wet1_lane,
                      const float* wet2, int wet2_lane, const float* dry,
                      int dry_lane, float* out_l, float* out_r) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)V * n) return;
  srk_fv_mix(i, V, n, raw, l_in, r_in, wet1, wet1_lane, wet2, wet2_lane, dry,
             dry_lane, out_l, out_r);
}

extern "C" int srk_freeverb(SRK_FV_ARGS, void* stream) {
  if (V <= 0 || n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  srk_fv_kernel<<<(2 * V + SRK_FV_BLOCK - 1) / SRK_FV_BLOCK, SRK_FV_BLOCK, 0,
                  s>>>(l_in, r_in, damp, damp_lane, feed, feed_lane, in_gain,
                       fs, lines, lens, offs, raw, V, n, chunk);
  const size_t total = (size_t)V * n;
  srk_fv_mix_kernel<<<(unsigned)((total + SRK_FV_MIX_BLOCK - 1) /
                                 SRK_FV_MIX_BLOCK),
                      SRK_FV_MIX_BLOCK, 0, s>>>(
      V, n, raw, l_in, r_in, wet1, wet1_lane, wet2, wet2_lane, dry, dry_lane,
      out_l, out_r);
  return (int)cudaGetLastError();
}

#else

extern "C" int srk_freeverb(SRK_FV_ARGS) {
  for (int ch = 0; ch < 2; ++ch)
    for (int v = 0; v < V; ++v)
      srk_fv_voice(v, ch, V, n, chunk, l_in, r_in, damp, damp_lane, feed,
                   feed_lane, in_gain, fs, lines, lens, offs, raw);
  for (size_t i = 0; i < (size_t)V * n; ++i)
    srk_fv_mix(i, V, n, raw, l_in, r_in, wet1, wet1_lane, wet2, wet2_lane,
               dry, dry_lane, out_l, out_r);
  return 0;
}

#endif
