// Per-sample module steps of the fused voice kernel, one inline function per
// module type, callable from host code (the test build with g++) and device
// code (the kernel built with nvcc).
//
// Each function mirrors the torch step of srack_tpu_torch/modules/*.py and
// the JAX step of srack_tpu/modules/*.py expression by expression, in f32
// (the exact Oscillator's phase in double),
// so the three agree to the rounding: build with `--fmad=false` (nvcc) or
// `-ffp-contract=off` (g++), and never with fast math, so that a*b+c stays
// two roundings and divisions stay IEEE.
//
// Calling convention, followed by ops/fused.py's generator:
//
//   fn<CONN, statics...>(params..., state..., const float* in, float* out)
//
// * CONN: bit i set when input port i is connected.  An unconnected input
//   arrives as 0.0f and the function applies the module's fallback.
// * statics: the module's integer and boolean statics, in order.
// * params: the module's derived params in sorted key order, by value
//   (a float vector param as a pointer, an int table as an srk_rows view
//   into the packed int rows).  Which params exist depends on the
//   connectivity (ModuleDef.derive hoists loop-invariant chains) and on
//   automation (an automated module skips derive), and the overloads below
//   take the hoisted path exactly when the torch step does.  An automated
//   param arrives as this sample's lane value in the param's place.
// * state: the module's state leaves in sorted key order, by reference
//   (a vector leaf as a pointer); bool state is carried as int.
// * x: for a module with a hoisted lane (Noise, an Input with a driver),
//   this sample of the lane, after the state.
// * in / out: the input ports and output ports, in port order.
//
// The generated file defines SRK_SAMPLE_RATE before including this header.

#pragma once

#include <stdint.h>
#include <math.h>
#include <string.h>

#ifndef SRK_SAMPLE_RATE
#error "define SRK_SAMPLE_RATE (the patch's sample rate in Hz) before including modules.cuh"
#endif

#ifdef __CUDACC__
#define SRK_HD __host__ __device__ __forceinline__
#else
#define SRK_HD inline
#endif

// 440 / sample_rate, computed in double and rounded to f32 once, as the
// Python steps fold it.
#define SRK_K440_SR ((float)(440.0 / (double)(SRK_SAMPLE_RATE)))

// ---------------------------------------------------------------------------
// fast-mode helpers (srack_tpu_torch/ops/basic.py)
// ---------------------------------------------------------------------------

SRK_HD float srk_int_as_float(int x) {
#ifdef __CUDA_ARCH__
  return __int_as_float(x);
#else
  float f;
  memcpy(&f, &x, sizeof f);
  return f;
#endif
}

// int32 add that wraps mod 2^32 (signed overflow is undefined in C++)
SRK_HD int srk_iadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

// jnp.clip / torch.clamp: a NaN passes through
SRK_HD float srk_clip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// jnp.mod(x, 1.0): the C remainder, moved into [0, 1) when negative.
// x - truncf(x) is exact and equals fmodf(x, 1.0f) for every finite x but
// the sign of a zero result, which the int conversion in
// srk_delta_to_fixed drops; fmodf is a libdevice loop with branches, 6.7 %
// slower on the subtractive voice (H100 80GB HBM3, 700 W).
SRK_HD float srk_mod1(float x) {
  float r = x - truncf(x);
  return r < 0.0f ? r + 1.0f : r;
}

// f32 cycles per sample -> fixed-point int32 phase increment.  Only the
// value in int32 range is converted: float-to-int of a value >= 2^31 is
// undefined in C++.
SRK_HD int srk_delta_to_fixed(float delta) {
  float d = srk_mod1(delta);
  float u = d * 4294967296.0f;
  return d < 0.5f ? (int)u : (int)(u - 4294967296.0f);
}

// int32 fixed-point phase -> signed turns in [-1, 1)
SRK_HD float srk_signed_turns(int pos) {
  return (float)pos * 4.656612873077393e-10f;  // 2^-31
}

// sin(pi*s) on [-1, 1]: 5-term odd minimax polynomial, Horner form
SRK_HD float srk_fast_sinpi(float s) {
  float z = s * s;
  float p = 0.0640261396169806f;
  p = p * z + -0.5818593382178273f;
  p = p * z + 2.5427129265355948f;
  p = p * z + -5.166401774862824f;
  p = p * z + 3.1415278983587682f;
  return s * p;
}

// 2**x: deg-6 polynomial on the fractional part, times 2**floor(x) built
// as float exponent bits
SRK_HD float srk_fast_exp2(float x) {
  x = srk_clip(x, -126.0f, 126.0f);
  float xi = floorf(x);
  float f = x - xi;
  float p = 0.00021702400581973962f;
  p = p * f + 0.0012439646470418081f;
  p = p * f + 0.009678845362499107f;
  p = p * f + 0.05548333989618637f;
  p = p * f + 0.24022983671380171f;
  p = p * f + 0.6931469838082407f;
  p = p * f + 1.0000000018561317f;
  int e = ((int)xi + 127) << 23;
  return p * srk_int_as_float(e);
}

// One voice's int table param, [K] or [R, K] row-major, in the packed int
// rows: entry j is the j-th row after the table's first, V ints apart.
// A warp's 32 voices read 32 neighbouring ints.
struct srk_rows {
  const int* p;
  size_t stride;
  SRK_HD int operator[](int j) const { return p[(size_t)j * stride]; }
};

// table[idx] as the JAX package's binary select tree answers it: the tree
// reads the low log2(P) bits of idx (P = K rounded up to a power of two)
// and pads the table with its last entry.  For idx in [0, K) it is
// table[idx].  One load, not a select chain.
template <int K>
SRK_HD int srk_table(const srk_rows& table, int idx) {
  constexpr int P = K <= 1 ? 1 : (K <= 2 ? 2 : (K <= 4 ? 4 : (K <= 8 ? 8 :
                    (K <= 16 ? 16 : (K <= 32 ? 32 : (K <= 64 ? 64 :
                    (K <= 128 ? 128 : 256)))))));
  static_assert(K <= 256, "sequencer tables hold at most 64 steps");
  const int j = idx & (P - 1);
  return table[j < K ? j : K - 1];
}

// polyBLEP in the signed-phase domain: sign(-u) * (1 - |u|)^2 for |u| < 1
SRK_HD float srk_poly_blep_signed(float u) {
  float au = fabsf(u);
  float w = 1.0f - au;
  float mag = au < 1.0f ? w * w : 0.0f;
  return u >= 0.0f ? -mag : mag;
}

// ---------------------------------------------------------------------------
// Oscillator (modules/oscillator.py), fast precision.
// in: CV, Sync.  out: Sine, Square, Sawtooth.
// state (sorted): pos (int32 fixed-point phase), pos_g (float shadow phase),
// sync_last (bool as int).
// ---------------------------------------------------------------------------

template <int CONN, int ANTIALIAS>
SRK_HD void srk_osc_core(float delta, int dfix, int& pos, float& pos_g,
                         int& sync_last, const float* in, float* out) {
  bool fired = false;
  if constexpr ((CONN & 2) != 0) {
    bool above = in[1] > 0.0f;
    fired = above && !sync_last;
    sync_last = above;
  } else {
    sync_last = 0;  // Sync unconnected: the detector state becomes False
  }
  const int pos_i = fired ? 0 : pos;
  const float acc = fired ? 0.0f : pos_g;
  pos = srk_iadd(pos_i, dfix);
  pos_g = acc + delta;

  const float s = srk_signed_turns(pos_i);
  out[0] = srk_fast_sinpi(s);
  const float naive_square = pos_i >= 0 ? -1.0f : 1.0f;
  const float naive_saw = s + naive_square;
  if constexpr (ANTIALIAS != 0) {
    const float inv2dt = 0.5f / delta;
    const float blep0 = srk_poly_blep_signed(s * inv2dt);
    const float blep_half = srk_poly_blep_signed(naive_saw * inv2dt);
    out[1] = naive_square - (blep0 - blep_half);
    out[2] = naive_saw - blep0;
  } else {
    out[1] = naive_square;
    out[2] = naive_saw;
  }
}

// CV unconnected: the pitch chain was hoisted (params delta, dfix, val)
template <int CONN, int ANTIALIAS>
SRK_HD void srk_oscillator(float delta, int dfix, float val, int& pos,
                           float& pos_g, int& sync_last, const float* in,
                           float* out) {
  static_assert((CONN & 1) == 0, "hoisted pitch needs CV unconnected");
  srk_osc_core<CONN, ANTIALIAS>(delta, dfix, pos, pos_g, sync_last, in, out);
}

// The pitch of a sample from its CV (params: val): the increment and its
// fixed-point form.  No state enters it, so a stage warp's sample group
// (ops/fused.py) runs it for every sample of the group before the group's
// steps: the IEEE division of srk_osc_core, whose slow-path branch ends
// a block of code the scheduler cannot leave, then parts no pitch chain
// from another.
template <int CONN>
SRK_HD void srk_osc_pitch(float val, float cv, float& delta, int& dfix) {
  const float octs = (CONN & 1) != 0 ? cv + val : val;
  delta = srk_fast_exp2(octs) * SRK_K440_SR;
  dfix = srk_delta_to_fixed(delta);
}

// pitch computed per sample (params: val)
template <int CONN, int ANTIALIAS>
SRK_HD void srk_oscillator(float val, int& pos, float& pos_g, int& sync_last,
                           const float* in, float* out) {
  float delta;
  int dfix;
  srk_osc_pitch<CONN>(val, in[0], delta, dfix);
  srk_osc_core<CONN, ANTIALIAS>(delta, dfix, pos, pos_g, sync_last, in, out);
}

// ---------------------------------------------------------------------------
// Oscillator (modules/oscillator.py), exact precision: the reference's f64
// phase.  state (sorted): pos (double), sync_last (bool as int); params:
// delta (double, hoisted with CV unconnected) and val.  The phase, the
// increment 440 * 2^octs / sr (in that order), the floor-mod wrap, sin and
// the polyBLEPs are doubles; the outputs are cast to f32, as the torch
// step's.  The overloads differ from the fast ones in their arity and in
// the double& phase, so a plan's call resolves by its leaves' types.
// ---------------------------------------------------------------------------

// jnp.mod(x, 1.0) / torch.remainder in double: x - trunc(x) is exact and
// equals fmod(x, 1.0) for every finite x but the sign of a zero result,
// moved into [0, 1) when negative (r + 1.0 rounds as theirs does)
SRK_HD double srk_mod1_f64(double x) {
  const double r = x - trunc(x);
  return r < 0.0 ? r + 1.0 : r;
}

// polyBLEP of the exact phase (ops/basic.py::poly_blep); with dt == 0 the
// selects give 0
SRK_HD double srk_poly_blep(double t, double dt) {
  const double lo = t / dt;
  const double lo_val = lo + lo - lo * lo - 1.0;
  const double hi = (t - 1.0) / dt;
  const double hi_val = hi * hi + hi + hi + 1.0;
  return t < dt ? lo_val : (t > 1.0 - dt ? hi_val : 0.0);
}

template <int CONN, int ANTIALIAS>
SRK_HD void srk_osc_exact(double delta, double& pos, int& sync_last,
                          const float* in, float* out) {
  bool fired = false;
  if constexpr ((CONN & 2) != 0) {
    bool above = in[1] > 0.0f;
    fired = above && !sync_last;
    sync_last = above;
  } else {
    sync_last = 0;  // Sync unconnected: the detector state becomes False
  }
  const double p = fired ? 0.0 : pos;
  pos = srk_mod1_f64(p + delta);
  out[0] = (float)sin(p * 6.283185307179586);  // 2 pi, as Python's double
  const float naive_square = p < 0.5 ? -1.0f : 1.0f;
  const float naive_saw = (float)p * 2.0f - 1.0f;
  if constexpr (ANTIALIAS != 0) {
    const double blep0 = srk_poly_blep(p, delta);
    const double blep_half = srk_poly_blep(srk_mod1_f64(p + 0.5), delta);
    out[1] = naive_square - (float)(blep0 - blep_half);
    out[2] = naive_saw - (float)blep0;
  } else {
    out[1] = naive_square;
    out[2] = naive_saw;
  }
}

// CV unconnected: the increment was hoisted (params delta, val)
template <int CONN, int ANTIALIAS>
SRK_HD void srk_oscillator(double delta, float val, double& pos,
                           int& sync_last, const float* in, float* out) {
  static_assert((CONN & 1) == 0, "hoisted pitch needs CV unconnected");
  srk_osc_exact<CONN, ANTIALIAS>(delta, pos, sync_last, in, out);
}

// the exact increment computed per sample (params: val)
template <int CONN, int ANTIALIAS>
SRK_HD void srk_oscillator(float val, double& pos, int& sync_last,
                           const float* in, float* out) {
  const double octs = (CONN & 1) != 0 ? (double)in[0] + (double)val
                                      : (double)val;
  const double delta = 440.0 * exp2(octs) / (double)SRK_SAMPLE_RATE;
  srk_osc_exact<CONN, ANTIALIAS>(delta, pos, sync_last, in, out);
}

// ---------------------------------------------------------------------------
// Add / Subtract / Multiply / Non-Linear (modules/math.py).
// in: In1 (fallback 0.0), In2 (fallback: the constant param).  out: 1.
// ---------------------------------------------------------------------------

template <int CONN>
SRK_HD float srk_math_a(const float* in) {
  return (CONN & 1) != 0 ? in[0] : 0.0f;
}

template <int CONN>
SRK_HD float srk_math_b(float constant, const float* in) {
  return (CONN & 2) != 0 ? in[1] : constant;
}

template <int CONN>
SRK_HD void srk_add(float constant, const float* in, float* out) {
  out[0] = srk_math_a<CONN>(in) + srk_math_b<CONN>(constant, in);
}

template <int CONN>
SRK_HD void srk_subtract(float constant, const float* in, float* out) {
  out[0] = srk_math_a<CONN>(in) - srk_math_b<CONN>(constant, in);
}

template <int CONN>
SRK_HD void srk_multiply(float constant, const float* in, float* out) {
  out[0] = srk_math_a<CONN>(in) * srk_math_b<CONN>(constant, in);
}

template <int CONN>
SRK_HD void srk_non_linear(float constant, const float* in, float* out) {
  const float a = srk_math_a<CONN>(in);
  const float b = srk_math_b<CONN>(constant, in);
  out[0] = a > 0.0f ? powf(a, b) : -powf(-a, b);
}

// ---------------------------------------------------------------------------
// Moog Filter (modules/filter.py).  in: Audio, CV.  out: lp, bp, hp.
// state: b, the 5-stage vector.
// ---------------------------------------------------------------------------

SRK_HD void srk_moog_coefs(float frequency, float res, float& p, float& f,
                           float& q) {
  const float q0 = 1.0f - frequency;
  p = frequency + 0.8f * frequency * q0;
  f = p * 2.0f - 1.0f;
  q = res * (1.0f + 0.5f * q0 * (1.0f - q0 + 5.6f * q0 * q0));
}

SRK_HD void srk_moog_stage(float* b, float audio, float p, float f, float q,
                           float* out) {
  const float x = audio - q * b[4];
  const float nb1 = (x + b[0]) * p - b[1] * f;
  const float nb2 = (nb1 + b[1]) * p - b[2] * f;
  const float nb3 = (nb2 + b[2]) * p - b[3] * f;
  float nb4 = (nb3 + b[3]) * p - b[4] * f;
  nb4 = nb4 - nb4 * nb4 * nb4 * 0.166667f;
  b[0] = srk_clip(x, -1.0f, 1.0f);
  b[1] = srk_clip(nb1, -1.0f, 1.0f);
  b[2] = srk_clip(nb2, -1.0f, 1.0f);
  b[3] = srk_clip(nb3, -1.0f, 1.0f);
  b[4] = srk_clip(nb4, -1.0f, 1.0f);
  out[0] = b[4];                  // lowpass
  out[1] = 3.0f * (b[3] - b[4]);  // bandpass
  out[2] = x - b[4];              // highpass
}

// CV unconnected: coefficients hoisted
// (params exp_amt, freq, moog_f, moog_p, moog_q, res, res_clip)
template <int CONN>
SRK_HD void srk_moog_filter(float exp_amt, float freq, float moog_f,
                            float moog_p, float moog_q, float res,
                            float res_clip, float* b, const float* in,
                            float* out) {
  static_assert((CONN & 2) == 0, "hoisted coefficients need CV unconnected");
  const float audio = (CONN & 1) != 0 ? in[0] : 0.0f;
  srk_moog_stage(b, audio, moog_p, moog_f, moog_q, out);
}

// coefficients per sample (params exp_amt, freq, res, res_clip)
template <int CONN>
SRK_HD void srk_moog_filter(float exp_amt, float freq, float res,
                            float res_clip, float* b, const float* in,
                            float* out) {
  const float audio = (CONN & 1) != 0 ? in[0] : 0.0f;
  const float cv = (CONN & 2) != 0 ? in[1] : 0.0f;
  const float frequency = srk_clip(freq + cv * exp_amt, 0.0f, 0.9f);
  float p, f, q;
  srk_moog_coefs(frequency, res_clip, p, f, q);
  srk_moog_stage(b, audio, p, f, q, out);
}

// automated (derive skipped): res clipped per sample (params exp_amt,
// freq, res)
template <int CONN>
SRK_HD void srk_moog_filter(float exp_amt, float freq, float res, float* b,
                            const float* in, float* out) {
  srk_moog_filter<CONN>(exp_amt, freq, res, srk_clip(res, 0.0f, 1.0f), b,
                        in, out);
}

// ---------------------------------------------------------------------------
// ADSR (modules/adsr.py).  in: Gate.  out: 1.
// params (derived): a_sec, d_sec, inc_a, inc_d, inc_r, r_sec, s_val.
// state (sorted): from_a_val, gate_last (bool as int), k, mode, p0, r_val.
// Every mode's update is computed and the current mode's selected, as in
// the torch step: selects, not branches, so the 32 voices of a warp, each
// in its own mode, take one path, and a stage warp's sample groups
// (ops/fused.py) stay one block of straight-line code.
// ---------------------------------------------------------------------------

// c ? a : b as one select instruction.  nvcc turns a chain of ?: on one
// value (the ADSR's mode) back into a switch of branches; an inline selp
// stays a select.
SRK_HD float srk_sel(bool c, float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("{ .reg .pred p; setp.ne.u32 p, %3, 0; selp.f32 %0, %1, %2, p; }"
      : "=f"(r) : "f"(a), "f"(b), "r"((unsigned)c));
  return r;
#else
  return c ? a : b;
#endif
}

SRK_HD int srk_sel(bool c, int a, int b) {
#ifdef __CUDA_ARCH__
  int r;
  asm("{ .reg .pred p; setp.ne.u32 p, %3, 0; selp.s32 %0, %1, %2, p; }"
      : "=r"(r) : "r"(a), "r"(b), "r"((unsigned)c));
  return r;
#else
  return c ? a : b;
#endif
}

SRK_HD float srk_adsr_out_law(int mode, float phase, float r_mid,
                              float s_val) {
  const float up = r_mid + (1.0f - r_mid) * phase;
  const float down = s_val + (1.0f - s_val) * (1.0f - phase);
  const float rel = s_val * (1.0f - phase);
  return srk_sel(mode == 0, 0.0f, srk_sel(mode == 1, up, srk_sel(
      mode == 2, down, srk_sel(mode == 3, s_val, rel))));
}

template <int CONN>
SRK_HD void srk_adsr(float a_sec, float d_sec, float inc_a, float inc_d,
                     float inc_r, float r_sec, float s_val,
                     float& from_a_val, int& gate_last, int& k, int& mode,
                     float& p0, float& r_val, const float* in, float* out) {
  const float gate = (CONN & 1) != 0 ? in[0] : 0.0f;
  const bool gate_hi = gate > 0.0f;
  const bool fired = gate_hi && !gate_last;
  const int k1 = srk_iadd(k, 1);
  const float kf = (float)k1;

  // candidate next phase per stage: phase = p0 + (k+1)*inc
  const float pa = p0 + kf * inc_a;
  const float pd = p0 + kf * inc_d;
  const float pr = gate_hi ? inc_r : p0 + kf * inc_r;

  // idle (0): a high gate starts the attack
  const int mode_n = gate_hi ? 1 : 0;
  const int k_n = gate_hi ? 0 : k;
  const float p0_n = gate_hi ? 0.0f : p0;
  // attack (1)
  const bool a_done = pa >= 1.0f;
  const bool retrig = !a_done && fired;
  const bool a_leave = a_done || retrig;
  const int mode_a = a_done ? 2 : 1;
  const int k_a = a_leave ? 0 : k1;
  const float p0_a = a_leave ? 0.0f : p0;
  const float ph_a = a_leave ? 0.0f : pa;
  const float rmid_a = retrig ? from_a_val : r_val;
  // decay (2)
  const bool d_done = pd >= 1.0f;
  const bool d_leave = fired || d_done;
  const int mode_d = fired ? 1 : (d_done ? 3 : 2);
  const int k_d = d_leave ? 0 : k1;
  const float p0_d = d_leave ? 0.0f : p0;
  const float ph_d = d_leave ? 0.0f : pd;
  // sustain (3)
  const bool s_leave = !gate_hi || fired;
  const int mode_s = fired ? 1 : (!gate_hi ? 4 : 3);
  const int k_s = s_leave ? 0 : k;
  const float p0_s = s_leave ? 0.0f : p0;
  // release (any other mode); a gate-high retrigger keeps the release
  // increment as the attack entry offset: phase' = inc_r, counted from
  // k' = 0
  const bool r_done = pr >= 1.0f;
  const int mode_r = r_done ? 0 : (gate_hi ? 1 : 4);
  const int k_r = (r_done || gate_hi) ? 0 : k1;
  const float p0_r = r_done ? 0.0f : (gate_hi ? pr : p0);
  const float ph_r = r_done ? 0.0f : pr;
  const float rmid_r = r_done ? 0.0f : r_val;

  const bool m0 = mode == 0, m1 = mode == 1, m2 = mode == 2, m3 = mode == 3;
  const int new_mode = srk_sel(m0, mode_n, srk_sel(m1, mode_a, srk_sel(
      m2, mode_d, srk_sel(m3, mode_s, mode_r))));
  const int new_k = srk_sel(m0, k_n, srk_sel(m1, k_a, srk_sel(
      m2, k_d, srk_sel(m3, k_s, k_r))));
  const float new_p0 = srk_sel(m0, p0_n, srk_sel(m1, p0_a, srk_sel(
      m2, p0_d, srk_sel(m3, p0_s, p0_r))));
  const float phase = srk_sel(m0, 0.0f, srk_sel(m1, ph_a, srk_sel(
      m2, ph_d, srk_sel(m3, 0.0f, ph_r))));
  const float r_mid = srk_sel(m0, r_val, srk_sel(m1, rmid_a, srk_sel(
      m2, r_val, srk_sel(m3, r_val, rmid_r))));

  const float o = srk_adsr_out_law(new_mode, phase, r_mid, s_val);
  r_val = srk_sel(new_mode != 1, o, r_mid);
  from_a_val = srk_sel(new_mode == 1, o, from_a_val);
  mode = new_mode;
  k = new_k;
  p0 = new_p0;
  gate_last = gate_hi;
  out[0] = o;
}

// automated (derive skipped): the stage increments 1 / (sr * t_sec) per
// sample (params a_sec, d_sec, r_sec, s_val)
template <int CONN>
SRK_HD void srk_adsr(float a_sec, float d_sec, float r_sec, float s_val,
                     float& from_a_val, int& gate_last, int& k, int& mode,
                     float& p0, float& r_val, const float* in, float* out) {
  const float sr = (float)SRK_SAMPLE_RATE;
  srk_adsr<CONN>(a_sec, d_sec, 1.0f / (sr * a_sec), 1.0f / (sr * d_sec),
                 1.0f / (sr * r_sec), r_sec, s_val, from_a_val, gate_last, k,
                 mode, p0, r_val, in, out);
}

// ---------------------------------------------------------------------------
// VCA (modules/vca.py).  in: Audio, CV.  out: 1.  statics: negative.
// ---------------------------------------------------------------------------

template <int CONN, int NEGATIVE>
SRK_HD void srk_vca(const float* in, float* out) {
  if constexpr ((CONN & 3) != 3) {
    out[0] = 0.0f;  // either input unconnected: silence
  } else if constexpr (NEGATIVE != 0) {
    out[0] = in[0] * in[1];
  } else {
    out[0] = in[1] > 0.0f ? in[0] * in[1] : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// Mono Mixer (modules/mixer.py).  in: N signals.  out: 1.  statics: N.
// params: gain, a vector of N.  Unconnected inputs are skipped.
// ---------------------------------------------------------------------------

template <int CONN, int N>
SRK_HD void srk_mono_mixer(const float* gain, const float* in, float* out) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (((CONN >> i) & 1) != 0) acc = acc + in[i] * gain[i];
  }
  out[0] = acc;
}

// ---------------------------------------------------------------------------
// Grid and Pattern sequencers (modules/sequencer.py), per-sample steps.
// in: Step, Sync (an unconnected input is the constant 0.0f).
// state (sorted): current_step, [last_cv,] step_last, sync_last (bools as
// int).  statics: grid (octaves, capacity), pattern (rows, capacity).
// ---------------------------------------------------------------------------

// the shared step pointer: count Step edges, reset on a Sync edge, wrap at
// n_steps (the int32 add wraps, as jnp's)
SRK_HD int srk_advance_step(int& current_step, int& step_last,
                            int& sync_last, float step_in, float sync_in,
                            int n_steps) {
  const bool step_above = step_in > 0.0f;
  const bool step_fired = step_above && !step_last;
  const bool sync_above = sync_in > 0.0f;
  const bool sync_fired = sync_above && !sync_last;
  step_last = step_above;
  sync_last = sync_above;
  int cs = srk_iadd(current_step, step_fired ? 1 : 0);
  cs = sync_fired ? 0 : cs;
  return cs >= n_steps ? 0 : cs;
}

// The grid's packed entry is note * 4 + cell.  jnp splits it with floor
// semantics (packed % 4, packed // 4); C's % and / truncate, so they would
// split a negative note differently.  & 3 and >> 2 are the floor forms in
// two's complement.
SRK_HD void srk_grid_emit(int packed, int cs, float inv_spo, float step_in,
                          float& last_cv, float* out) {
  const int cell = packed & 3;
  const int note = packed >> 2;
  const float note_cv = (float)note * inv_spo;
  const bool on = cell > 0;
  last_cv = on ? note_cv : last_cv;
  out[0] = last_cv;
  out[1] = on ? (cell == 2 ? 1.0f : step_in) : 0.0f;
  out[2] = cs == 0 ? 1.0f : 0.0f;
}

// hoisted (params cells, inv_spo, n_steps, notes, packed_tbl,
// steps_per_octave): one table load per sample
template <int CONN, int OCTAVES, int CAP>
SRK_HD void srk_grid_sequencer(const srk_rows& cells, float inv_spo,
                               int n_steps, const srk_rows& notes,
                               const srk_rows& packed_tbl,
                               int steps_per_octave, int& current_step,
                               float& last_cv, int& step_last,
                               int& sync_last, const float* in, float* out) {
  const float step_in = (CONN & 1) != 0 ? in[0] : 0.0f;
  const float sync_in = (CONN & 2) != 0 ? in[1] : 0.0f;
  const int cs = srk_advance_step(current_step, step_last, sync_last,
                                  step_in, sync_in, n_steps);
  current_step = cs;
  srk_grid_emit(srk_table<CAP>(packed_tbl, cs), cs, inv_spo, step_in,
                last_cv, out);
}

// Pattern: 8 rows packed 2 bits each into one table entry.  Row r's cell
// is (packed >> 2r) & 3 (an arithmetic shift, as jnp's on int32).
template <int CONN, int ROWS, int CAP>
SRK_HD void srk_pattern_sequencer(const srk_rows& cells, int n_steps,
                                  const srk_rows& packed_tbl,
                                  int& current_step, int& step_last,
                                  int& sync_last, const float* in,
                                  float* out) {
  const float step_in = (CONN & 1) != 0 ? in[0] : 0.0f;
  const float sync_in = (CONN & 2) != 0 ? in[1] : 0.0f;
  const int cs = srk_advance_step(current_step, step_last, sync_last,
                                  step_in, sync_in, n_steps);
  current_step = cs;
  const int packed = srk_table<CAP>(packed_tbl, cs);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int col = (packed >> (2 * r)) & 3;
    out[r] = col == 2 ? 1.0f : (col == 1 ? step_in : 0.0f);
  }
  out[ROWS] = cs == 0 ? 1.0f : 0.0f;
}

// ---------------------------------------------------------------------------
// Input (modules/input.py): the driver lane when one is bound, else the
// constant param.  Noise (modules/oscillator.py): its lane of draws.
// ---------------------------------------------------------------------------

template <int CONN>
SRK_HD void srk_input(float value, const float* in, float* out) {
  out[0] = value;
}

template <int CONN>
SRK_HD void srk_input(float value, float x, const float* in, float* out) {
  out[0] = x;
}

template <int CONN>
SRK_HD void srk_noise(float x, const float* in, float* out) {
  out[0] = x;
}

// ---------------------------------------------------------------------------
// Output (modules/output.py): the audio write.  `channel` is this voice's
// row of one channel, [n] floats; an unconnected channel writes 0.0f.
// ---------------------------------------------------------------------------

SRK_HD void srk_output(float* channel, int t, float value) {
  channel[t] = value;
}
