// Adjoints of the per-sample module steps of modules.cuh: the vector-Jacobian
// products that the backward kernel of the fused VJP (K10, generated by
// srack_tpu_torch/ops/fused.py in its "bwd" mode) calls once per module per
// sample, in reverse plan order.  Callable from host and device code, like
// the steps.
//
// Each adjoint differentiates what JAX differentiates in the step of
// srack_tpu/modules/*.py, not the textbook function:
//
// * floor, int conversions, comparisons and the int32 phase have zero
//   derivative: fast_exp2' is p'(f) * 2^floor(x), not ln2 * 2^x;
// * jnp.clip is minimum(maximum(x, lo), hi): derivative 1 inside, 0
//   outside, 1/2 at a bound (a tie splits it; torch.clamp gives 1 there);
// * abs' is +1 at 0 (JAX's select rule), which the polyBLEP meets at every
//   phase reset;
// * a where routes the cotangent to the selected branch only, and the other
//   branch's VJP still runs on a zero cotangent, so 0 * NaN stays NaN (the
//   Non-Linear's powf of a negative base gives NaN gradients, as in JAX);
// * the Oscillator's straight-through shadow s + 2 * (acc - stop_grad(acc))
//   sends 2 * d(wave)/ds to pos_g, and a Sync reset zeroes it.
//
// Calling convention (ops/fused.py emits the calls):
//
//   fn_adj<CONN, statics...>(P..., S..., [x,] in, DP..., DS..., dout, din)
//
// * P, S, x, in: the step's params (automated ones as this sample's lane
//   value), the module's state BEFORE the step (by value; a vector leaf as
//   a const pointer), the lane sample and the input ports, recomputed by
//   the kernel from the state stored for this sample.
// * DP: one accumulator per float param, in the order of P (float& or, for
//   a vector param, float*): the adjoint adds its cotangent.  Int params
//   and tables get none.
// * DS: one per float state leaf, in the order of S: in, the cotangent of
//   the state after the step; out, that of the state before it.  Int and
//   bool state get none.
// * dout: the cotangents of the output ports; din: zero-initialised by the
//   caller, the adjoint adds the input ports' cotangents (an unconnected
//   port's is dropped by the caller).  Lanes get no cotangent.

#pragma once

#include "modules.cuh"

SRK_HD int srk_float_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_int(x);
#else
  int i;
  memcpy(&i, &x, sizeof i);
  return i;
#endif
}

// jnp.nan_to_num on the audio cotangent, as JAX's fused VJP applies it
SRK_HD float srk_nan_to_num(float x) {
  if (x != x) return 0.0f;
  if (x > 3.40282347e38f) return 3.40282347e38f;
  if (x < -3.40282347e38f) return -3.40282347e38f;
  return x;
}

// d jnp.clip(x, lo, hi) / dx: maximum(lo, x), then minimum(hi, .), each
// with JAX's balanced tie rule
SRK_HD float srk_clip_d(float x, float lo, float hi) {
  const float m = x > lo ? x : lo;
  const float dm = x == m ? (lo == m ? 0.5f : 1.0f) : 0.0f;
  const float c = m < hi ? m : hi;
  const float dc = m == c ? (hi == c ? 0.5f : 1.0f) : 0.0f;
  return dm * dc;
}

// d sin(pi s) / ds of the polynomial srk_fast_sinpi
SRK_HD float srk_fast_sinpi_d(float s) {
  const float z = s * s;
  float p = 0.0640261396169806f;
  float dp = 0.0f;
  dp = dp * z + p;
  p = p * z + -0.5818593382178273f;
  dp = dp * z + p;
  p = p * z + 2.5427129265355948f;
  dp = dp * z + p;
  p = p * z + -5.166401774862824f;
  dp = dp * z + p;
  p = p * z + 3.1415278983587682f;
  return p + s * dp * (s + s);
}

// d srk_fast_exp2(x) / dx: the polynomial's derivative times the exponent
// scale (floor and the bit cast have zero derivative), times the clip's
SRK_HD float srk_fast_exp2_d(float x) {
  const float xc = srk_clip(x, -126.0f, 126.0f);
  const float xi = floorf(xc);
  const float f = xc - xi;
  float p = 0.00021702400581973962f;
  float dp = 0.0f;
  dp = dp * f + p;
  p = p * f + 0.0012439646470418081f;
  dp = dp * f + p;
  p = p * f + 0.009678845362499107f;
  dp = dp * f + p;
  p = p * f + 0.05548333989618637f;
  dp = dp * f + p;
  p = p * f + 0.24022983671380171f;
  dp = dp * f + p;
  p = p * f + 0.6931469838082407f;
  dp = dp * f + p;
  const int e = ((int)xi + 127) << 23;
  return dp * srk_int_as_float(e) * srk_clip_d(x, -126.0f, 126.0f);
}

// the cotangent of u given g, the cotangent of srk_poly_blep_signed(u):
// |u| (derivative +1 at 0), w = 1 - |u|, mag = |u| < 1 ? w * w : 0,
// out = u >= 0 ? -mag : mag, transposed select by select
SRK_HD float srk_poly_blep_signed_vjp(float u, float g) {
  const float au = fabsf(u);
  const float w = 1.0f - au;
  const float g_mag = u >= 0.0f ? -g : g;
  const float g_ww = au < 1.0f ? g_mag : 0.0f;
  const float g_au = -(g_ww * w + g_ww * w);
  return u >= 0.0f ? g_au : -g_au;
}

// ---------------------------------------------------------------------------
// Oscillator.  dout: Sine, Square, Sawtooth.  DS: pos_g.
// ---------------------------------------------------------------------------

// the waves' and the shadow phase's adjoint: adds the cotangent of delta
// to g_delta; d_pos_g goes from the new shadow phase's to the old one's
template <int CONN, int ANTIALIAS>
SRK_HD void srk_osc_core_adj(float delta, int pos, int sync_last,
                             const float* in, float& g_delta, float& d_pos_g,
                             const float* dout) {
  bool fired = false;
  if constexpr ((CONN & 2) != 0) {
    fired = in[1] > 0.0f && !sync_last;
  }
  const int pos_i = fired ? 0 : pos;
  const float s = srk_signed_turns(pos_i);
  float g_s = dout[0] * srk_fast_sinpi_d(s);
  float g_saw = dout[2];  // of naive_saw = s + naive_square
  if constexpr (ANTIALIAS != 0) {
    const float naive_square = pos_i >= 0 ? -1.0f : 1.0f;
    const float naive_saw = s + naive_square;
    const float inv2dt = 0.5f / delta;
    // square = naive_square - (blep0 - blep_half), saw = naive_saw - blep0
    const float g_u0 = srk_poly_blep_signed_vjp(s * inv2dt,
                                                -dout[1] - dout[2]);
    const float g_uh = srk_poly_blep_signed_vjp(naive_saw * inv2dt, dout[1]);
    g_s += g_u0 * inv2dt;
    g_saw += g_uh * inv2dt;
    const float g_inv2dt = g_u0 * s + g_uh * naive_saw;
    g_delta += -g_inv2dt * (0.5f / (delta * delta));
  }
  g_s += g_saw;
  // s = turns + 2 * ste with ste = acc - stop_grad(acc); new pos_g = acc +
  // delta; acc = fired ? 0 : pos_g
  const float g_acc = (g_s + g_s) + d_pos_g;
  g_delta += d_pos_g;
  d_pos_g = fired ? 0.0f : g_acc;
}

// hoisted pitch (params delta, dfix, val): delta's cotangent goes to the
// derived param; autograd chains it to val through ModuleDef.derive
template <int CONN, int ANTIALIAS>
SRK_HD void srk_oscillator_adj(float delta, int dfix, float val, int pos,
                               float pos_g, int sync_last, const float* in,
                               float& d_delta, float& d_val, float& d_pos_g,
                               const float* dout, float* din) {
  srk_osc_core_adj<CONN, ANTIALIAS>(delta, pos, sync_last, in, d_delta,
                                    d_pos_g, dout);
}

// pitch per sample (params: val)
template <int CONN, int ANTIALIAS>
SRK_HD void srk_oscillator_adj(float val, int pos, float pos_g,
                               int sync_last, const float* in, float& d_val,
                               float& d_pos_g, const float* dout, float* din) {
  const float octs = (CONN & 1) != 0 ? in[0] + val : val;
  const float delta = srk_fast_exp2(octs) * SRK_K440_SR;
  float g_delta = 0.0f;
  srk_osc_core_adj<CONN, ANTIALIAS>(delta, pos, sync_last, in, g_delta,
                                    d_pos_g, dout);
  const float g_octs = g_delta * SRK_K440_SR * srk_fast_exp2_d(octs);
  d_val += g_octs;
  if constexpr ((CONN & 1) != 0) din[0] += g_octs;
}

// ---------------------------------------------------------------------------
// Add / Subtract / Multiply / Non-Linear.  DP: constant.
// ---------------------------------------------------------------------------

template <int CONN>
SRK_HD void srk_math_b_adj(float g, float& d_constant, float* din) {
  if constexpr ((CONN & 2) != 0) {
    din[1] += g;
  } else {
    d_constant += g;
  }
}

template <int CONN>
SRK_HD void srk_add_adj(float constant, const float* in, float& d_constant,
                        const float* dout, float* din) {
  if constexpr ((CONN & 1) != 0) din[0] += dout[0];
  srk_math_b_adj<CONN>(dout[0], d_constant, din);
}

template <int CONN>
SRK_HD void srk_subtract_adj(float constant, const float* in,
                             float& d_constant, const float* dout,
                             float* din) {
  if constexpr ((CONN & 1) != 0) din[0] += dout[0];
  srk_math_b_adj<CONN>(-dout[0], d_constant, din);
}

template <int CONN>
SRK_HD void srk_multiply_adj(float constant, const float* in,
                             float& d_constant, const float* dout,
                             float* din) {
  const float a = srk_math_a<CONN>(in);
  const float b = srk_math_b<CONN>(constant, in);
  if constexpr ((CONN & 1) != 0) din[0] += dout[0] * b;
  srk_math_b_adj<CONN>(dout[0] * a, d_constant, din);
}

// where(a > 0, pow(a, b), -pow(-a, b)): both branches' VJPs run, the
// unselected one on a zero cotangent.  JAX's pow rules: d/dx = y *
// pow(x, y - 1), d/dy = log(x or 1 where x == 0) * pow(x, y).
template <int CONN>
SRK_HD void srk_non_linear_adj(float constant, const float* in,
                               float& d_constant, const float* dout,
                               float* din) {
  const float a = srk_math_a<CONN>(in);
  const float b = srk_math_b<CONN>(constant, in);
  const bool sel = a > 0.0f;
  const float g1 = sel ? dout[0] : 0.0f;   // of pow(a, b)
  const float g2 = sel ? 0.0f : -dout[0];  // of pow(-a, b)
  const float na = -a;
  const float ga = g1 * (b * powf(a, b - 1.0f)) - g2 * (b * powf(na, b - 1.0f));
  const float gb = g1 * (logf(a == 0.0f ? 1.0f : a) * powf(a, b))
                   + g2 * (logf(na == 0.0f ? 1.0f : na) * powf(na, b));
  if constexpr ((CONN & 1) != 0) din[0] += ga;
  srk_math_b_adj<CONN>(gb, d_constant, din);
}

// ---------------------------------------------------------------------------
// Moog Filter.  dout: lp, bp, hp.  DS: b, the 5-stage vector.
// ---------------------------------------------------------------------------

// the ladder's adjoint: db from the new stage vector's cotangent to the old
// one's; adds the cotangents of audio, p, f and q
SRK_HD void srk_moog_stage_adj(const float* b, float audio, float p, float f,
                               float q, float* db, const float* dout,
                               float& g_audio, float& g_p, float& g_f,
                               float& g_q) {
  const float x = audio - q * b[4];
  const float nb1 = (x + b[0]) * p - b[1] * f;
  const float nb2 = (nb1 + b[1]) * p - b[2] * f;
  const float nb3 = (nb2 + b[2]) * p - b[3] * f;
  const float r4 = (nb3 + b[3]) * p - b[4] * f;
  const float t1 = r4 * r4;
  const float nb4 = r4 - t1 * r4 * 0.166667f;
  // outputs: lp = b4', bp = 3 * (b3' - b4'), hp = x - b4'
  const float g_bp3 = dout[1] * 3.0f;
  float g_x = dout[2];
  const float gn0 = db[0];
  const float gn1 = db[1];
  const float gn2 = db[2];
  const float gn3 = db[3] + g_bp3;
  const float gn4 = db[4] + dout[0] - g_bp3 - dout[2];
  // b' = clip(pre-clip stages, -1, 1)
  g_x += gn0 * srk_clip_d(x, -1.0f, 1.0f);
  const float g1 = gn1 * srk_clip_d(nb1, -1.0f, 1.0f);
  const float g2 = gn2 * srk_clip_d(nb2, -1.0f, 1.0f);
  const float g3 = gn3 * srk_clip_d(nb3, -1.0f, 1.0f);
  const float g4 = gn4 * srk_clip_d(nb4, -1.0f, 1.0f);
  // nb4 = r4 - r4 * r4 * r4 * c
  const float g_t2 = -g4 * 0.166667f;
  const float g_t1 = g_t2 * r4;
  const float g_r4 = g4 + g_t2 * t1 + (g_t1 * r4 + g_t1 * r4);
  // r4 = (nb3 + b3) * p - b4 * f, and down the ladder
  const float g_nb3 = g3 + g_r4 * p;
  float g_b3 = g_r4 * p;
  g_p += g_r4 * (nb3 + b[3]);
  float g_b4 = -g_r4 * f;
  g_f += -g_r4 * b[4];
  const float g_nb2 = g2 + g_nb3 * p;
  float g_b2 = g_nb3 * p;
  g_p += g_nb3 * (nb2 + b[2]);
  g_b3 += -g_nb3 * f;
  g_f += -g_nb3 * b[3];
  const float g_nb1 = g1 + g_nb2 * p;
  float g_b1 = g_nb2 * p;
  g_p += g_nb2 * (nb1 + b[1]);
  g_b2 += -g_nb2 * f;
  g_f += -g_nb2 * b[2];
  g_x += g_nb1 * p;
  const float g_b0 = g_nb1 * p;
  g_p += g_nb1 * (x + b[0]);
  g_b1 += -g_nb1 * f;
  g_f += -g_nb1 * b[1];
  // x = audio - q * b4
  g_audio += g_x;
  g_q += -g_x * b[4];
  g_b4 += -g_x * q;
  db[0] = g_b0;
  db[1] = g_b1;
  db[2] = g_b2;
  db[3] = g_b3;
  db[4] = g_b4;
}

// srk_moog_coefs' adjoint: adds the cotangents of frequency and res
SRK_HD void srk_moog_coefs_adj(float frequency, float res, float g_p,
                               float g_f, float g_q, float& g_freq,
                               float& g_res) {
  const float q0 = 1.0f - frequency;
  const float bq = 1.0f - q0 + 5.6f * q0 * q0;
  const float aq = 1.0f + 0.5f * q0 * bq;
  g_res += g_q * aq;
  const float g_aq = g_q * res;
  const float g_bq = g_aq * (0.5f * q0);
  float g_q0 = g_aq * bq * 0.5f;
  g_q0 += -g_bq + (g_bq * q0 * 5.6f + g_bq * (5.6f * q0));
  g_p += g_f * 2.0f;
  g_q0 += g_p * (0.8f * frequency);
  g_freq += g_p + g_p * q0 * 0.8f - g_q0;
}

template <int CONN>
SRK_HD void srk_moog_audio_adj(float g_audio, float* din) {
  if constexpr ((CONN & 1) != 0) din[0] += g_audio;
}

// hoisted coefficients (params exp_amt, freq, moog_f, moog_p, moog_q, res,
// res_clip): their cotangents go to the derived params
template <int CONN>
SRK_HD void srk_moog_filter_adj(float exp_amt, float freq, float moog_f,
                                float moog_p, float moog_q, float res,
                                float res_clip, const float* b,
                                const float* in, float& d_exp_amt,
                                float& d_freq, float& d_moog_f,
                                float& d_moog_p, float& d_moog_q,
                                float& d_res, float& d_res_clip, float* db,
                                const float* dout, float* din) {
  const float audio = (CONN & 1) != 0 ? in[0] : 0.0f;
  float g_audio = 0.0f;
  srk_moog_stage_adj(b, audio, moog_p, moog_f, moog_q, db, dout, g_audio,
                     d_moog_p, d_moog_f, d_moog_q);
  srk_moog_audio_adj<CONN>(g_audio, din);
}

// coefficients per sample from a clipped res: adds res_clip's cotangent to
// g_res_clip
template <int CONN>
SRK_HD void srk_moog_cv_adj(float exp_amt, float freq, float res_clip,
                            const float* b, const float* in,
                            float& d_exp_amt, float& d_freq,
                            float& g_res_clip, float* db, const float* dout,
                            float* din) {
  const float audio = (CONN & 1) != 0 ? in[0] : 0.0f;
  const float cv = (CONN & 2) != 0 ? in[1] : 0.0f;
  const float pre = freq + cv * exp_amt;
  const float frequency = srk_clip(pre, 0.0f, 0.9f);
  float p, f, q;
  srk_moog_coefs(frequency, res_clip, p, f, q);
  float g_audio = 0.0f, g_p = 0.0f, g_f = 0.0f, g_q = 0.0f, g_fr = 0.0f;
  srk_moog_stage_adj(b, audio, p, f, q, db, dout, g_audio, g_p, g_f, g_q);
  srk_moog_coefs_adj(frequency, res_clip, g_p, g_f, g_q, g_fr, g_res_clip);
  const float g_pre = g_fr * srk_clip_d(pre, 0.0f, 0.9f);
  d_freq += g_pre;
  d_exp_amt += g_pre * cv;
  if constexpr ((CONN & 2) != 0) din[1] += g_pre * exp_amt;
  srk_moog_audio_adj<CONN>(g_audio, din);
}

// coefficients per sample (params exp_amt, freq, res, res_clip)
template <int CONN>
SRK_HD void srk_moog_filter_adj(float exp_amt, float freq, float res,
                                float res_clip, const float* b,
                                const float* in, float& d_exp_amt,
                                float& d_freq, float& d_res,
                                float& d_res_clip, float* db,
                                const float* dout, float* din) {
  srk_moog_cv_adj<CONN>(exp_amt, freq, res_clip, b, in, d_exp_amt, d_freq,
                        d_res_clip, db, dout, din);
}

// automated (params exp_amt, freq, res): res clipped per sample
template <int CONN>
SRK_HD void srk_moog_filter_adj(float exp_amt, float freq, float res,
                                const float* b, const float* in,
                                float& d_exp_amt, float& d_freq, float& d_res,
                                float* db, const float* dout, float* din) {
  float g_res_clip = 0.0f;
  srk_moog_cv_adj<CONN>(exp_amt, freq, srk_clip(res, 0.0f, 1.0f), b, in,
                        d_exp_amt, d_freq, g_res_clip, db, dout, din);
  d_res += g_res_clip * srk_clip_d(res, 0.0f, 1.0f);
}

// ---------------------------------------------------------------------------
// ADSR.  DS: from_a_val, p0, r_val.  The gate has no derivative.
// ---------------------------------------------------------------------------

// replays the step's selects, then transposes the selected path: adds the
// increments' and s_val's cotangents; the state cotangents go from the new
// state's to the old state's
template <int CONN>
SRK_HD void srk_adsr_core_adj(float inc_a, float inc_d, float inc_r,
                              float s_val, float from_a_val, int gate_last,
                              int k, int mode, float p0, float r_val,
                              const float* in, float& g_inc_a,
                              float& g_inc_d, float& g_inc_r, float& d_s_val,
                              float& d_from_a_val, float& d_p0,
                              float& d_r_val, const float* dout) {
  const float gate = (CONN & 1) != 0 ? in[0] : 0.0f;
  const bool gate_hi = gate > 0.0f;
  const bool fired = gate_hi && !gate_last;
  const float kf = (float)srk_iadd(k, 1);
  const float pa = p0 + kf * inc_a;
  const float pd = p0 + kf * inc_d;
  const float pr = gate_hi ? inc_r : p0 + kf * inc_r;

  // which value each selected output took: phase from 0 (none), pa, pd or
  // pr; r_mid from r_val, from_a_val or 0; new p0 from p0 or pr (or 0)
  int new_mode, phase_src = 0, rmid_src = 0;
  bool keep_p0, p0_from_pr = false;
  float phase = 0.0f;
  if (mode == 0) {
    new_mode = gate_hi ? 1 : 0;
    keep_p0 = !gate_hi;
  } else if (mode == 1) {
    const bool a_done = pa >= 1.0f;
    const bool retrig = !a_done && fired;
    const bool leave = a_done || retrig;
    new_mode = a_done ? 2 : 1;
    keep_p0 = !leave;
    phase_src = leave ? 0 : 1;
    rmid_src = retrig ? 1 : 0;
  } else if (mode == 2) {
    const bool d_done = pd >= 1.0f;
    const bool leave = fired || d_done;
    new_mode = fired ? 1 : (d_done ? 3 : 2);
    keep_p0 = !leave;
    phase_src = leave ? 0 : 2;
  } else if (mode == 3) {
    const bool leave = !gate_hi || fired;
    new_mode = fired ? 1 : (!gate_hi ? 4 : 3);
    keep_p0 = !leave;
  } else {
    const bool r_done = pr >= 1.0f;
    new_mode = r_done ? 0 : (gate_hi ? 1 : 4);
    keep_p0 = !r_done && !gate_hi;
    p0_from_pr = !r_done && gate_hi;
    phase_src = r_done ? 0 : 3;
    rmid_src = r_done ? 2 : 0;
  }
  if (phase_src == 1) phase = pa;
  if (phase_src == 2) phase = pd;
  if (phase_src == 3) phase = pr;
  const float r_mid = rmid_src == 0 ? r_val
                      : (rmid_src == 1 ? from_a_val : 0.0f);

  // new r_val = new_mode != 1 ? out : r_mid; new from_a_val = new_mode == 1
  // ? out : from_a_val; out = the law
  float g_o = dout[0] + (new_mode != 1 ? d_r_val : 0.0f)
              + (new_mode == 1 ? d_from_a_val : 0.0f);
  float g_rmid = new_mode != 1 ? 0.0f : d_r_val;
  float g_fa = new_mode == 1 ? 0.0f : d_from_a_val;
  float g_ph = 0.0f;
  if (new_mode == 1) {          // r_mid + (1 - r_mid) * phase
    g_rmid += g_o - g_o * phase;
    g_ph += g_o * (1.0f - r_mid);
  } else if (new_mode == 2) {   // s + (1 - s) * (1 - phase)
    d_s_val += g_o - g_o * (1.0f - phase);
    g_ph += -(g_o * (1.0f - s_val));
  } else if (new_mode == 3) {   // s
    d_s_val += g_o;
  } else if (new_mode == 4) {   // s * (1 - phase)
    d_s_val += g_o * (1.0f - phase);
    g_ph += -(g_o * s_val);
  }
  float g_rv = 0.0f;
  if (rmid_src == 0) g_rv += g_rmid;
  if (rmid_src == 1) g_fa += g_rmid;
  float g_p0 = keep_p0 ? d_p0 : 0.0f;
  float g_pr = p0_from_pr ? d_p0 : 0.0f;
  const float g_pa = phase_src == 1 ? g_ph : 0.0f;
  const float g_pd = phase_src == 2 ? g_ph : 0.0f;
  g_pr += phase_src == 3 ? g_ph : 0.0f;
  g_p0 += g_pa + g_pd;
  g_inc_a += g_pa * kf;
  g_inc_d += g_pd * kf;
  if (gate_hi) {
    g_inc_r += g_pr;
  } else {
    g_p0 += g_pr;
    g_inc_r += g_pr * kf;
  }
  d_p0 = g_p0;
  d_r_val = g_rv;
  d_from_a_val = g_fa;
}

// derived increments (params a_sec, d_sec, inc_a, inc_d, inc_r, r_sec,
// s_val): the times' cotangents come through ModuleDef.derive
template <int CONN>
SRK_HD void srk_adsr_adj(float a_sec, float d_sec, float inc_a, float inc_d,
                         float inc_r, float r_sec, float s_val,
                         float from_a_val, int gate_last, int k, int mode,
                         float p0, float r_val, const float* in,
                         float& d_a_sec, float& d_d_sec, float& d_inc_a,
                         float& d_inc_d, float& d_inc_r, float& d_r_sec,
                         float& d_s_val, float& d_from_a_val, float& d_p0,
                         float& d_r_val, const float* dout, float* din) {
  srk_adsr_core_adj<CONN>(inc_a, inc_d, inc_r, s_val, from_a_val, gate_last,
                          k, mode, p0, r_val, in, d_inc_a, d_inc_d, d_inc_r,
                          d_s_val, d_from_a_val, d_p0, d_r_val, dout);
}

// d (1 / (sr * t)) / dt as JAX's div rule gives it, times g
SRK_HD float srk_inv_time_adj(float t, float g) {
  const float sr = (float)SRK_SAMPLE_RATE;
  const float y = sr * t;
  return (-g * (1.0f / (y * y))) * sr;
}

// automated (params a_sec, d_sec, r_sec, s_val): increments per sample
template <int CONN>
SRK_HD void srk_adsr_adj(float a_sec, float d_sec, float r_sec, float s_val,
                         float from_a_val, int gate_last, int k, int mode,
                         float p0, float r_val, const float* in,
                         float& d_a_sec, float& d_d_sec, float& d_r_sec,
                         float& d_s_val, float& d_from_a_val, float& d_p0,
                         float& d_r_val, const float* dout, float* din) {
  const float sr = (float)SRK_SAMPLE_RATE;
  float g_a = 0.0f, g_d = 0.0f, g_r = 0.0f;
  srk_adsr_core_adj<CONN>(1.0f / (sr * a_sec), 1.0f / (sr * d_sec),
                          1.0f / (sr * r_sec), s_val, from_a_val, gate_last,
                          k, mode, p0, r_val, in, g_a, g_d, g_r, d_s_val,
                          d_from_a_val, d_p0, d_r_val, dout);
  d_a_sec += srk_inv_time_adj(a_sec, g_a);
  d_d_sec += srk_inv_time_adj(d_sec, g_d);
  d_r_sec += srk_inv_time_adj(r_sec, g_r);
}

// ---------------------------------------------------------------------------
// VCA, Mono Mixer.
// ---------------------------------------------------------------------------

template <int CONN, int NEGATIVE>
SRK_HD void srk_vca_adj(const float* in, const float* dout, float* din) {
  if constexpr ((CONN & 3) == 3) {
    const float g = (NEGATIVE != 0 || in[1] > 0.0f) ? dout[0] : 0.0f;
    din[0] += g * in[1];
    din[1] += g * in[0];
  }
}

template <int CONN, int N>
SRK_HD void srk_mono_mixer_adj(const float* gain, const float* in,
                               float* d_gain, const float* dout, float* din) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (((CONN >> i) & 1) != 0) {
      din[i] += dout[0] * gain[i];
      d_gain[i] += dout[0] * in[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Grid and Pattern sequencers: the step pointer is discrete; the Step input
// passes to a gate output on a cell that takes it, and the grid's CV is
// note * inv_spo or the held last_cv.  DS (grid): last_cv.
// ---------------------------------------------------------------------------

template <int CONN, int OCTAVES, int CAP>
SRK_HD void srk_grid_sequencer_adj(const srk_rows& cells, float inv_spo,
                                   int n_steps, const srk_rows& notes,
                                   const srk_rows& packed_tbl,
                                   int steps_per_octave, int current_step,
                                   float last_cv, int step_last,
                                   int sync_last, const float* in,
                                   float& d_inv_spo, float& d_last_cv,
                                   const float* dout, float* din) {
  const float step_in = (CONN & 1) != 0 ? in[0] : 0.0f;
  const float sync_in = (CONN & 2) != 0 ? in[1] : 0.0f;
  const int cs = srk_advance_step(current_step, step_last, sync_last,
                                  step_in, sync_in, n_steps);
  const int packed = srk_table<CAP>(packed_tbl, cs);
  const int cell = packed & 3;
  const bool on = cell > 0;
  const float g_cv = dout[0] + d_last_cv;
  d_inv_spo += (on ? g_cv : 0.0f) * (float)(packed >> 2);
  d_last_cv = on ? 0.0f : g_cv;
  if constexpr ((CONN & 1) != 0) {
    din[0] += (on && cell != 2) ? dout[1] : 0.0f;
  }
}

template <int CONN, int ROWS, int CAP>
SRK_HD void srk_pattern_sequencer_adj(const srk_rows& cells, int n_steps,
                                      const srk_rows& packed_tbl,
                                      int current_step, int step_last,
                                      int sync_last, const float* in,
                                      const float* dout, float* din) {
  if constexpr ((CONN & 1) != 0) {
    const float step_in = in[0];
    const float sync_in = (CONN & 2) != 0 ? in[1] : 0.0f;
    const int cs = srk_advance_step(current_step, step_last, sync_last,
                                    step_in, sync_in, n_steps);
    const int packed = srk_table<CAP>(packed_tbl, cs);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (((packed >> (2 * r)) & 3) == 1) din[0] += dout[r];
    }
  }
}

// ---------------------------------------------------------------------------
// Input, Noise, Output.
// ---------------------------------------------------------------------------

template <int CONN>
SRK_HD void srk_input_adj(float value, const float* in, float& d_value,
                          const float* dout, float* din) {
  d_value += dout[0];
}

// a driven Input emits its lane, which gets no cotangent
template <int CONN>
SRK_HD void srk_input_adj(float value, float x, const float* in,
                          float& d_value, const float* dout, float* din) {}

template <int CONN>
SRK_HD void srk_noise_adj(float x, const float* in, const float* dout,
                          float* din) {}

// `channel_ct` is this voice's row of one channel's audio cotangent
SRK_HD void srk_output_adj(const float* channel_ct, int t, float& d_value) {
  d_value += srk_nan_to_num(channel_ct[t]);
}
