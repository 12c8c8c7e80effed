"""Per-module parity: each ported module's torch step against the JAX step.

Both get the same random params, state and input sequences, made with numpy
from a seed, for 4 voices at 4,800 Hz, and step together for tens to
hundreds of samples.  The JAX steps run
eagerly, one XLA computation per primitive, so XLA's CPU backend has no
``a*b+c`` to contract into FMA and the two packages round alike.

Tolerances: ADSR, VCA, Add/Subtract/Multiply, the mixer and the fast-mode
primitives must be bit-exact.  The Moog filter is held to atol=1e-30 (far
inside the 1e-6 the slice allows): with its input unconnected its stages
decay through the f32 subnormals, which XLA's CPU backend flushes to zero
and torch keeps (as the CUDA kernel does).  The oscillator must be
bit-exact in its int32 phase and within 1e-5 on the waves.  Non-Linear is
held to 1e-6 (rtol), because XLA's and torch's ``pow`` are different
implementations that may differ in the last ulp.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import srack_tpu as st
from srack_tpu import modules as jmods
from srack_tpu.ops import basic as jbasic

import srack_tpu_torch as stt
from srack_tpu_torch import modules as tmods
from srack_tpu_torch.ops import basic as tbasic

V = 4
SR = 4800
JCFG = st.AudioConfig(sample_rate=SR, channels=2, precision="fast")
TCFG = stt.AudioConfig(sample_rate=SR, channels=2, precision="fast")
# XLA's CPU backend flushes f32 subnormals (< 1.2e-38) to zero, torch keeps
# them; what that changes downstream stays below 1e-30, while one rounding
# step on any value above 1e-22 exceeds it
SUBNORMAL = 1e-30


def _j(tree):
    """numpy -> jnp.  The JAX steps are written for one voice and run here
    on ``[V]`` lanes without vmap (vmap's eager dispatch is slow); a vector
    leaf ``[V, k]`` goes in as ``[k, V]`` so that its ``b[i]`` and
    ``gain[i]`` reads pick lanes."""
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    if tree is None:
        return None
    a = np.asarray(tree)
    return jnp.asarray(a.T if a.ndim == 2 else a)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return None if tree is None else torch.from_numpy(np.array(tree))


def _np(tree, jax_side=False):
    if isinstance(tree, dict):
        return {k: _np(v, jax_side) for k, v in tree.items()}
    a = tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return a.T if jax_side and a.ndim == 2 else a


def run_both(type_name, statics, params, state, ins_seq, *, derive=False):
    """Step both packages through ``ins_seq`` (a list over samples of
    per-port ``[V]`` arrays or None).  Returns per-step (outs, state) pairs
    as numpy, JAX first."""
    jdef, tdef = jmods.CATALOG[type_name], tmods.CATALOG[type_name]
    connected = tuple(x is not None for x in ins_seq[0])
    jp, tp = _j(params), _t(params)
    if derive:
        jp = {**jp, **jdef.derive(JCFG, statics, jp, connected)}
        tp = {**tp, **tdef.derive(TCFG, statics, tp, connected)}
    tstep = tdef.step
    js, ts = _j(state), _t(state)
    out = []
    for ins in ins_seq:
        js, jo = jdef.step(JCFG, statics, jp, js,
                           [None if x is None else jnp.asarray(x)
                            for x in ins])
        ts, to = tstep(TCFG, statics, tp, ts,
                       [None if x is None else torch.from_numpy(x)
                        for x in ins])
        jo = tuple(np.broadcast_to(np.asarray(o), (V,)) for o in jo)
        to = tuple(np.broadcast_to(o.numpy(), (V,)) for o in to)
        out.append(((jo, _np(js, jax_side=True)), (to, _np(ts))))
    return out


def assert_states(jstate, tstate, float_atol=0.0):
    assert set(jstate) == set(tstate)
    for k, w in jstate.items():
        g = np.broadcast_to(tstate[k], w.shape)
        if w.dtype in (np.int32, np.bool_) or float_atol == 0.0:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=float_atol, rtol=0,
                                       err_msg=k)


def f32(rng, lo, hi, shape=(V,)):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def gate_seq(rng, n, max_run=40):
    """Per-voice square gates with random run lengths (so rising edges
    land in every envelope stage)."""
    g = np.empty((n, V), np.float32)
    for v in range(V):
        t, hi = 0, bool(rng.integers(2))
        while t < n:
            run = int(rng.integers(1, max_run))
            g[t:t + run, v] = rng.uniform(0.1, 1.0) if hi else \
                -rng.uniform(0.0, 1.0)
            t, hi = t + run, not hi
    return [g[i] for i in range(n)]


# ---------------------------------------------------------------------------
# fast-mode primitives
# ---------------------------------------------------------------------------

def test_fast_primitives_bit_exact():
    rng = np.random.default_rng(0)
    x = np.concatenate([f32(rng, -140, 140, (4000,)), f32(rng, -1, 1, (4000,)),
                        np.float32([-126, 126, -127, 127, 0, 0.5, -0.5, 1,
                                    -1, 0.999999, 1e-9, -1e-9])])
    s = np.clip(x / 140, -1, 1).astype(np.float32)
    pos = rng.integers(-2**31, 2**31, 8000, dtype=np.int64).astype(np.int32)
    pos = np.concatenate([pos, np.int32([0, -2**31, 2**31 - 1, 1, -1])])
    cases = [
        ("fast_exp2", x), ("fast_sinpi", s), ("delta_to_fixed", x / 7),
        ("signed_turns", pos), ("poly_blep_signed", x / 50),
    ]
    for name, arg in cases:
        want = np.asarray(getattr(jbasic, name)(jnp.asarray(arg)))
        got = getattr(tbasic, name)(torch.from_numpy(arg)).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    want = np.asarray(jnp.mod(jnp.asarray(x), 1.0))
    np.testing.assert_array_equal(tbasic.f32_mod1(torch.from_numpy(x)).numpy(),
                                  want)


# ---------------------------------------------------------------------------
# Oscillator
# ---------------------------------------------------------------------------

OSC_CASES = [(cv, sync, aa, derive)
             for cv in (False, True) for sync in (False, True)
             for aa in (True, False)
             for derive in ((False, True) if not cv else (True,))]


def _osc_inputs(cv, sync, seed, n=48):
    rng = np.random.default_rng(seed)
    params = {"val": f32(rng, -6.0, 4.0)}
    state = {"pos": rng.integers(-2**31, 2**31, V).astype(np.int32),
             "pos_g": f32(rng, -2.0, 2.0),
             "sync_last": rng.integers(0, 2, V).astype(bool)}
    syncs = gate_seq(rng, n, max_run=9)
    ins = [[f32(rng, -2.0, 2.0) if cv else None, syncs[t] if sync else None]
           for t in range(n)]
    return params, state, ins


@pytest.mark.parametrize("cv,sync,antialias,derive", OSC_CASES)
def test_oscillator_step(cv, sync, antialias, derive):
    """Pitch from val in [-6, 4] octaves (up to 1.5 cycles/sample at
    4,800 Hz, so delta_to_fixed's wrap and >= 0.5 branch both run), CV,
    Sync edges, and a random starting phase."""
    params, state, ins = _osc_inputs(cv, sync, 1 + 2 * cv + 4 * sync)
    steps = run_both("Oscillator", ("antialias", antialias), params, state,
                     ins, derive=derive)
    for (jo, js), (to, ts) in steps:
        for w, g in zip(jo, to):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(ts["pos"], js["pos"])
        assert_states(js, ts, float_atol=1e-5)


@pytest.mark.parametrize("cv,sync,antialias,derive", OSC_CASES)
def test_oscillator_nograd_step_is_bit_identical(cv, sync, antialias, derive):
    params, state, ins = _osc_inputs(cv, sync, 3)
    statics = ("antialias", antialias)
    tdef = tmods.OSCILLATOR
    tp = _t(params)
    if derive:
        tp = {**tp, **tdef.derive(TCFG, statics, tp, (cv, sync))}
    sa = sb = _t(state)
    for x in ins:
        x = [None if a is None else torch.from_numpy(a) for a in x]
        sa, oa = tdef.step(TCFG, statics, tp, sa, x)
        sb, ob = tdef.step_nograd(TCFG, statics, tp, sb, x)
        for a, b in zip(oa + tuple(sa.values()), ob + tuple(sb.values())):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Moog Filter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("derive", [False, True])
@pytest.mark.parametrize("cv", [False, True])
@pytest.mark.parametrize("audio", [False, True])
def test_moog_filter_step(audio, cv, derive):
    rng = np.random.default_rng(20 + audio + 2 * cv + 4 * derive)
    n = 64
    params = {"freq": f32(rng, -0.2, 1.1), "res": f32(rng, -0.2, 1.2),
              "exp_amt": f32(rng, 0.0, 1.0)}
    state = {"b": f32(rng, -1.0, 1.0, (V, 5))}
    ins = [[f32(rng, -1.5, 1.5) if audio else None,
            f32(rng, -1.0, 1.0) if cv else None] for _ in range(n)]
    for (jo, js), (to, ts) in run_both("Moog Filter", ("moog",), params,
                                       state, ins, derive=derive):
        for w, g in zip(jo, to):
            np.testing.assert_allclose(g, w, atol=SUBNORMAL, rtol=0)
        assert_states(js, ts, float_atol=SUBNORMAL)


# ---------------------------------------------------------------------------
# ADSR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("derive", [False, True])
def test_adsr_step_crosses_every_mode(derive):
    rng = np.random.default_rng(30 + derive)
    n = 400
    params = {"a_sec": np.float32([0.0, 0.004, 0.01, 0.02]),
              "d_sec": np.float32([0.006, 0.0, 0.015, 0.003]),
              "s_val": f32(rng, 0.0, 1.0),
              "r_sec": np.float32([0.01, 0.005, 0.0, 0.02])}
    state = {"mode": np.zeros(V, np.int32), "k": np.zeros(V, np.int32),
             "p0": np.zeros(V, np.float32), "r_val": np.zeros(V, np.float32),
             "from_a_val": np.zeros(V, np.float32),
             "gate_last": np.ones(V, bool)}
    ins = [[g] for g in gate_seq(rng, n)]
    modes = set()
    for (jo, js), (to, ts) in run_both("ADSR", ("adsr",), params, state, ins,
                                       derive=derive):
        np.testing.assert_array_equal(to[0], jo[0])
        assert_states(js, ts)
        modes.update(int(m) for m in ts["mode"])
    assert modes == {0, 1, 2, 3, 4}


def test_adsr_unconnected_gate():
    params = {"a_sec": np.float32([0.01] * V), "d_sec": np.float32([0.01] * V),
              "s_val": np.float32([0.5] * V), "r_sec": np.float32([0.01] * V)}
    state = {"mode": np.int32([0, 1, 3, 4]), "k": np.int32([0, 3, 0, 2]),
             "p0": np.float32([0, 0, 0, 0.1]),
             "r_val": np.float32([0, 0.2, 0.5, 0.4]),
             "from_a_val": np.float32([0, 0.3, 0, 0]),
             "gate_last": np.bool_([True, False, True, False])}
    for (jo, js), (to, ts) in run_both("ADSR", ("adsr",), params, state,
                                       [[None]] * 40, derive=True):
        np.testing.assert_array_equal(to[0], jo[0])
        assert_states(js, ts)


# ---------------------------------------------------------------------------
# VCA, Add / Subtract / Multiply / Non-Linear, Mono Mixer, Output
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("control", [False, True])
@pytest.mark.parametrize("audio", [False, True])
@pytest.mark.parametrize("negative", [False, True])
def test_vca_step(negative, audio, control):
    rng = np.random.default_rng(40)
    ins = [[f32(rng, -1, 1) if audio else None,
            f32(rng, -1, 1) if control else None] for _ in range(8)]
    for (jo, _), (to, _) in run_both("VCA", ("vca", negative), {}, {}, ins):
        np.testing.assert_array_equal(to[0], jo[0])


@pytest.mark.parametrize("in2", [False, True])
@pytest.mark.parametrize("in1", [False, True])
@pytest.mark.parametrize("op", ["Add", "Subtract", "Multiply", "Non-Linear"])
def test_math_step(op, in1, in2):
    rng = np.random.default_rng(50)
    statics = ("nonlinear",) if op == "Non-Linear" else ("math", op)
    params = {"constant": f32(rng, 0.5, 2.0)}
    ins = [[f32(rng, -2, 2) if in1 else None,
            f32(rng, 0.5, 2) if in2 else None] for _ in range(8)]
    for (jo, _), (to, _) in run_both(op, statics, params, {}, ins):
        if op == "Non-Linear":
            np.testing.assert_allclose(to[0], jo[0], rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(to[0], jo[0])


@pytest.mark.parametrize("mask", [0b0000, 0b0001, 0b0101, 0b1010, 0b1111])
def test_mono_mixer_step(mask):
    rng = np.random.default_rng(60 + mask)
    params = {"gain": f32(rng, 0.0, 2.0, (V, 4))}
    ins = [[f32(rng, -1, 1) if (mask >> i) & 1 else None for i in range(4)]
           for _ in range(8)]
    for (jo, _), (to, _) in run_both("Mono Mixer", ("mixer", 4), params, {},
                                     ins):
        np.testing.assert_array_equal(to[0], jo[0])


def test_output_step():
    rng = np.random.default_rng(70)
    ins = [[f32(rng, -1, 1), None]]
    ((jo, _), (to, _)), = run_both("Output", ("output", 2), {}, {}, ins)
    for w, g in zip(jo, to):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(to[1], np.zeros(V, np.float32))


def test_catalog_and_make_match_jax():
    for name, tdef in tmods.CATALOG.items():
        jdef = jmods.CATALOG[name]
        js, jp = jdef.make(JCFG)
        ts, tp = tdef.make(TCFG)
        assert js == ts, name
        assert set(jp) == set(tp), name
        for k in jp:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
        for port_fn in ("num_inputs", "num_outputs", "input_labels",
                        "output_labels"):
            assert getattr(jdef, port_fn)(JCFG, js) == \
                getattr(tdef, port_fn)(TCFG, ts), (name, port_fn)
        jinit = jdef.init_state(JCFG, js)
        tinit = tdef.init_state(TCFG, ts)
        assert set(jinit) == set(tinit), name
        for k in jinit:
            w = np.asarray(jinit[k])
            assert tinit[k].numpy().dtype == w.dtype, (name, k)
            np.testing.assert_array_equal(tinit[k].numpy(), w)
