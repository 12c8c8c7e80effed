"""Exact precision in the port against the JAX package, on the CPU.

``AudioConfig(precision="exact")``: the Oscillator's f64 phase and the
Freeverb's f64 core, as torch ``float64`` leaves (torch needs no x64
switch).

* **The numpy oracle.**  ``srack_tpu_torch.oracle.oracle_render`` equals
  ``srack_tpu.oracle.oracle_render`` bit for bit on the patches of
  ``tests/test_oracle_parity.py``, and the port's exact scan engine equals
  the port's oracle at each of those tests' own tolerances (1e-7 to
  2e-5).
* **The engines against JAX's**, from one seeded state (every Oscillator
  at a random f64 phase, every Freeverb line random): the port's exact
  scan engine against JAX's exact scan engine, audio within 1e-6, f64
  state within 1e-12, f32 state within 1e-6, int32 and bool state equal;
  the port's exact block engine against JAX's exact block engine within
  5e-6 (``tests/test_block_engine.py``'s block-vs-scan tolerance), on
  subtractive_voice, feedback_patch in both feedback modes, reverb_patch
  and drum_machine (its Noise fed one numpy lane in both packages).
* **The block forms**: the exact ``_osc_block`` (free-running, with a CV,
  a Sync, both, an automated ``val``) and the Freeverb's exact ``_step``
  and ``_block`` against JAX's within 1e-6.
* **The partitions** in exact precision equal the JAX package's (no
  synthesized stage seed, no absorption).
* **Fast against exact** within 1e-3 over one second
  (``tests/test_precision.py``'s twin, its sine), and on subtractive_voice
  the port's fast-against-exact difference is the JAX package's: the
  drift is the reference's, not the port's.  At 48 kHz over 1 s the
  reference's own drift on that voice passes 1e-3, and the port renders
  the stretch where it does as JAX does.  A JAX exact state crosses
  ``interop`` bit for bit, f64 leaves as f64.

The JAX renders come from ``tests/torch_parity_worker.py`` (its own
process, ``--xla_cpu_max_isa=AVX``, x64); the oracles, the partitions and
the round trip are built here.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srack_tpu as st
from srack_tpu import presets as jpresets
from srack_tpu.block_engine import BlockProgram as JaxBlockProgram
from srack_tpu.oracle import oracle_render as jax_oracle

import srack_tpu_torch as stt
from srack_tpu_torch import interop
from srack_tpu_torch.modules import freeverb as fv
from srack_tpu_torch.modules import oscillator as osc
from srack_tpu_torch.oracle import oracle_render as port_oracle
from srack_tpu_torch.ops.ring_roll import ring_align_plain

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_parity_worker.py"
SR, BLOCK = 4800, 64
N = BLOCK * 6
ENGINE_CASES = ("subtractive_voice", "feedback_patch", "feedback_buffer",
                "reverb_patch", "drum_machine")
OSC_CASES = ("free", "cv", "sync", "cv_sync", "auto_val")
F64 = torch.float64


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_exact") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run(
        [sys.executable, str(WORKER), str(out), "osc_exact",
         "freeverb_exact", "drift", "drift48",
         *[f"{c}@exact" for c in ENGINE_CASES]],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _tree(ref: dict, prefix: str) -> dict:
    """A nested dict of tensors from the worker's flat ``a/b/c`` keys; fb
    keys ``src:port`` become ``(src, port)`` tuples."""
    tree = {}
    for key, arr in ref.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        leaf = parts[-1]
        if parts[0] == "fb" and len(parts) == 2:
            src, port = leaf.split(":")
            leaf = (src, int(port))
        node[leaf] = torch.from_numpy(np.array(arr, copy=True))
    return tree


# -- the oracle: the patches of tests/test_oracle_parity.py -------------------

def _ocfg(pkg, channels=1):
    return pkg.AudioConfig(sample_rate=SR, block_size=BLOCK,
                           channels=channels, precision="exact")


def _ramp(lo=-1.0, hi=1.0):
    return np.linspace(lo, hi, N, dtype=np.float32)


def _clock(period=32, duty=0.5):
    t = np.arange(N)
    return ((t % period) < period * duty).astype(np.float32)


def _osc_waves(pkg):
    p = pkg.Patch(_ocfg(pkg, 3))
    o = p.add("Oscillator", val=0.25)
    cv = p.add("Input")
    p.connect(cv, 0, o, "CV")
    for c, port in enumerate(("Sine", "Square", "Sawtooth")):
        p.connect(o, port, p.output, c)
    return p, {cv.id: _ramp(-0.5, 2.0)}, 2e-5


def _osc_sync(pkg):
    p = pkg.Patch(_ocfg(pkg))
    o = p.add("Oscillator", val=-1.0)
    sync = p.add("Input")
    p.connect(sync, 0, o, "Sync")
    p.connect(o, "Sawtooth", p.output, 0)
    return p, {sync.id: _clock(period=50)}, 2e-5


def _moog(pkg):
    p = pkg.Patch(_ocfg(pkg, 3))
    f = p.add("Moog Filter", freq=0.3, res=0.7, exp_amt=0.25)
    audio, cv = p.add("Input"), p.add("Input")
    p.connect(audio, 0, f, "Audio")
    p.connect(cv, 0, f, "CV")
    for c in range(3):
        p.connect(f, c, p.output, c)
    rng = np.random.default_rng(42)
    return p, {audio.id: rng.uniform(-1, 1, N).astype(np.float32),
               cv.id: _ramp(0.0, 0.5)}, 1e-5


def _adsr(pkg):
    p = pkg.Patch(_ocfg(pkg))
    env = p.add("ADSR", a_sec=0.003, d_sec=0.004, s_val=0.6, r_sec=0.005)
    gate = p.add("Input")
    p.connect(gate, 0, env, "Gate")
    p.connect(env, 0, p.output, 0)
    g = np.zeros(N, dtype=np.float32)
    g[10:150] = g[160:170] = g[200:210] = g[230:360] = 1.0
    return p, {gate.id: g}, 1e-6


def _adsr_zero(pkg):
    p = pkg.Patch(_ocfg(pkg))
    env = p.add("ADSR", a_sec=0.0, d_sec=0.002, s_val=0.25, r_sec=0.0)
    gate = p.add("Input")
    p.connect(gate, 0, env, "Gate")
    p.connect(env, 0, p.output, 0)
    return p, {gate.id: _clock(period=100, duty=0.4)}, 1e-6


def _vca(pkg):
    p = pkg.Patch(_ocfg(pkg))
    vca = p.add("VCA")
    a, c = p.add("Input"), p.add("Input")
    p.connect(a, 0, vca, "Audio")
    p.connect(c, 0, vca, "CV")
    p.connect(vca, 0, p.output, 0)
    return p, {a.id: _ramp(), c.id: _ramp(1.0, -1.0)}, 1e-6


def _vca_silent(pkg):
    p = pkg.Patch(_ocfg(pkg))
    vca = p.add("VCA")
    a = p.add("Input", value=0.5)
    p.connect(a, 0, vca, "Audio")
    p.connect(vca, 0, p.output, 0)
    return p, {}, 1e-6


def _mixer(pkg):
    p = pkg.Patch(_ocfg(pkg))
    mix = p.add("Mono Mixer", gains=(0.5, 2.0, 1.0, 0.25))
    a, b = p.add("Input"), p.add("Input")
    p.connect(a, 0, mix, 0)
    p.connect(b, 0, mix, 3)
    p.connect(mix, 0, p.output, 0)
    return p, {a.id: _ramp(), b.id: _ramp(2, 0)}, 1e-6


def _math(op, const):
    def build(pkg):
        p = pkg.Patch(_ocfg(pkg, 2))
        m1 = p.add(op, constant=const)
        m2 = p.add(op)
        a, b = p.add("Input"), p.add("Input")
        p.connect(a, 0, m1, "In1")
        p.connect(a, 0, m2, "In1")
        p.connect(b, 0, m2, "In2")
        p.connect(m1, 0, p.output, 0)
        p.connect(m2, 0, p.output, 1)
        return p, {a.id: _ramp(), b.id: _ramp(3, -3)}, 1e-6
    return build


def _nonlinear(pkg):
    p = pkg.Patch(_ocfg(pkg))
    nl = p.add("Non-Linear", constant=1.7)
    a = p.add("Input")
    p.connect(a, 0, nl, "In1")
    p.connect(nl, 0, p.output, 0)
    return p, {a.id: _ramp()}, 1e-5


def _grid(pkg):
    seq = [None, (12, True), (3, False), None, (24, True), (7, True),
           (0, False), (14, True)]
    p = pkg.Patch(_ocfg(pkg, 3))
    gs = p.add("Grid Sequencer", sequence=seq, n_steps=8)
    clk, sync = p.add("Input"), p.add("Input")
    p.connect(clk, 0, gs, "Step")
    p.connect(sync, 0, gs, "Sync")
    for c, port in enumerate(("CV", "Gate", "Sync")):
        p.connect(gs, port, p.output, c)
    s = np.zeros(N, dtype=np.float32)
    s[200:205] = 1.0
    return p, {clk.id: _clock(period=16, duty=0.25), sync.id: s}, 1e-6


def _pattern(pkg):
    pattern = [[True, None, False, None] * 4, [None, True, None, True] * 4,
               [False] * 16, [True] * 16] + [[None] * 16] * 4
    p = pkg.Patch(_ocfg(pkg, 3))
    ps = p.add("Pattern Sequencer", pattern=pattern, n_steps=16)
    clk = p.add("Input")
    p.connect(clk, 0, ps, "Step")
    for c, port in enumerate(("0", "3", "Sync")):
        p.connect(ps, port, p.output, c)
    return p, {clk.id: _clock(period=10, duty=0.3)}, 1e-6


def _sample(pkg):
    wav = (np.sin(np.linspace(0, 20, 100)) * 0.8).astype(np.float32)
    p = pkg.Patch(_ocfg(pkg))
    smp = p.add("Sample", samples=wav, wav_sample_rate=SR * 2)
    gate, cv = p.add("Input"), p.add("Input")
    p.connect(gate, 0, smp, "Gate")
    p.connect(cv, 0, smp, "CV")
    p.connect(smp, 0, p.output, 0)
    return p, {gate.id: _clock(period=120, duty=0.5),
               cv.id: _ramp(-0.5, 0.5)}, 1e-6


def _freeverb(pkg):
    p = pkg.Patch(_ocfg(pkg, 2))
    rev = p.add("Freeverb", room_size=0.8, dampening=0.3, wet=1.0,
                width=0.7, dry=0.2)
    a = p.add("Input")
    p.connect(a, 0, rev, "Left")
    p.connect(rev, "Left", p.output, 0)
    p.connect(rev, "Right", p.output, 1)
    x = np.zeros(N, dtype=np.float32)
    x[0], x[97] = 1.0, -0.5
    return p, {a.id: x}, 1e-7


def _unconnected(pkg):
    p = pkg.Patch(_ocfg(pkg, 2))
    a = p.add("Input", value=0.25)
    p.connect(a, 0, p.output, 0)
    return p, {}, 1e-6


ORACLE_CASES = {
    "oscillator_waveforms": _osc_waves, "oscillator_sync": _osc_sync,
    "moog_filter": _moog, "adsr": _adsr, "adsr_zero_attack": _adsr_zero,
    "vca": _vca, "vca_missing_cv": _vca_silent, "mixer": _mixer,
    "add": _math("Add", 0.5), "subtract": _math("Subtract", -1.5),
    "multiply": _math("Multiply", 2.0), "non_linear": _nonlinear,
    "grid_sequencer": _grid, "pattern_sequencer": _pattern,
    "sample": _sample, "freeverb": _freeverb,
    "output_unconnected": _unconnected,
}


@pytest.mark.parametrize("name", list(ORACLE_CASES))
def test_oracle_equals_jax_oracle(name):
    jpatch, jdrv, _ = ORACLE_CASES[name](st)
    tpatch, tdrv, _ = ORACLE_CASES[name](stt)
    want = jax_oracle(jpatch, N, drivers=jdrv)
    got = port_oracle(tpatch, N, drivers=tdrv)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(ORACLE_CASES))
def test_exact_scan_engine_matches_oracle(name):
    patch, drivers, atol = ORACLE_CASES[name](stt)
    audio, _, state = stt.render(patch, N, drivers=drivers, device="cpu")
    want = port_oracle(patch, N, drivers=drivers)
    np.testing.assert_allclose(audio.numpy(), want, atol=atol, rtol=0)
    leaves = [t for sd in state["states"].values() for t in sd.values()]
    assert all(t.dtype != F64 for t in leaves) == (
        not any(i.mdef.type_name in ("Oscillator", "Freeverb")
                for i in patch))


# -- the engines against JAX's ------------------------------------------------

def _port_build(name):
    base = "feedback_patch" if name == "feedback_buffer" else name
    cfg = stt.AudioConfig(sample_rate=SR, block_size=BLOCK,
                          channels=2 if base == "reverb_patch" else 1,
                          precision="exact",
                          buffer_feedback=name == "feedback_buffer")
    return getattr(stt.presets, base)(cfg)


def _engine_inputs(jax_ref, name):
    tag = f"{name}@exact"
    patch = _port_build(name)
    compiled = stt.compile_patch(patch)
    params = _tree(jax_ref, f"{tag}/params")
    params = {m: params.get(m, {}) for m in compiled.instances}
    state = _tree(jax_ref, f"{tag}/state")
    state = {"states": {m: state.get("states", {}).get(m, {})
                        for m in compiled.instances},
             "fb": state.get("fb", {})}
    drivers = {k: v for k, v in _tree(jax_ref, f"{tag}/drivers").items()}
    return patch, compiled, params, state, drivers


def _canonical(state, compiled):
    """Every Freeverb ring in time order (write index 0)."""
    out = {"states": {}, "fb": state["fb"]}
    for mid, sd in state["states"].items():
        sd = dict(sd)
        if compiled.instances[mid][0].type_name == "Freeverb":
            for k in [k for k in sd if f"{k}_idx" in sd]:
                sd[k] = ring_align_plain(sd[k], sd[f"{k}_idx"])
                sd[f"{k}_idx"] = torch.zeros_like(sd[f"{k}_idx"])
        out["states"][mid] = sd
    return out


def _assert_state(got, want, f64_tol, f32_tol, where, skip=()):
    for mid, sd in want["states"].items():
        assert set(got["states"][mid]) == set(sd), (where, mid)
        for k, w in sd.items():
            if (mid, k) in skip:
                continue
            g = got["states"][mid][k]
            assert g.dtype == w.dtype and g.shape == w.shape, (where, mid, k)
            if w.dtype in (torch.int32, torch.bool):
                assert torch.equal(g, w), (where, mid, k)
            else:
                tol = f64_tol if w.dtype == F64 else f32_tol
                torch.testing.assert_close(g, w, atol=tol, rtol=0,
                                           msg=f"{where} {mid}.{k}")
    assert set(got["fb"]) == set(want["fb"]), where
    for k, w in want["fb"].items():
        torch.testing.assert_close(got["fb"][k], w, atol=f32_tol, rtol=0)


@pytest.mark.parametrize("name", ENGINE_CASES)
def test_exact_scan_engine_matches_jax(jax_ref, name):
    patch, compiled, params, state, drivers = _engine_inputs(jax_ref, name)
    audio, _, final = compiled.render(N, params=params, state=state,
                                      drivers=drivers, batched=True,
                                      engine="scan", device="cpu")
    want = torch.from_numpy(jax_ref[f"{name}@exact/scan/audio"])
    torch.testing.assert_close(audio, want, atol=1e-6, rtol=0)
    assert audio.abs().max() > 1e-3
    jfinal = _tree(jax_ref, f"{name}@exact/scan/final")
    jfinal = {"states": {m: jfinal.get("states", {}).get(m, {})
                         for m in compiled.instances},
              "fb": jfinal.get("fb", {})}
    _assert_state(final, jfinal, 1e-12, 1e-6, name)


@pytest.mark.parametrize("name", ENGINE_CASES)
def test_exact_block_engine_matches_jax(jax_ref, name):
    """From the seeded state (random f64 phases): the port's block engine
    on CPU tensors (its kernels' plain versions) against JAX's, within
    5e-6; the final state too (rings in time order), and the block render
    against the port's own scan engine."""
    patch, compiled, params, state, drivers = _engine_inputs(jax_ref, name)
    prog = compiled.block_program()
    assert prog.kernel_ok and stt.block_engine.eligible(compiled)
    audio, _, final = compiled.render(N, params=params, state=state,
                                      drivers=drivers, batched=True,
                                      engine="block", device="cpu")
    want = torch.from_numpy(jax_ref[f"{name}@exact/block/audio"])
    torch.testing.assert_close(audio, want, atol=5e-6, rtol=0)
    scan = torch.from_numpy(jax_ref[f"{name}@exact/scan/audio"])
    torch.testing.assert_close(audio, scan, atol=5e-6, rtol=0)
    jfinal = _tree(jax_ref, f"{name}@exact/block/final")
    jfinal = {"states": {m: jfinal.get("states", {}).get(m, {})
                         for m in compiled.instances},
              "fb": jfinal.get("fb", {})}
    # an unconnected Sync's edge state: the step writes False, the block
    # form keeps it (a reference quirk both packages share); never read
    _assert_state(_canonical(final, compiled), _canonical(jfinal, compiled),
                  5e-6, 5e-6, name)


def test_exact_segments_and_one_voice_keep_f64_leaves():
    """An exact render in segments carries f64 state and equals one
    render; one unbatched voice through the block engine equals the scan
    engine; ``render_long``, ``render_stream`` and ``render_many`` take
    exact patches; ``migrate_state`` keeps f64 leaves f64."""
    patch = stt.presets.reverb_patch(stt.AudioConfig(
        sample_rate=SR, channels=2, precision="exact"))
    compiled = stt.compile_patch(patch)
    params = stt.presets.farm_params(patch, 2)
    kw = dict(params=params, batched=True, device="cpu", engine="block")
    one, _, s1 = compiled.render(256, **kw)
    seg, _, s2 = compiled.render(256, segment=64, **kw)
    torch.testing.assert_close(seg, one, atol=5e-6, rtol=0)
    verb = next(i.id for i in patch if i.name == "verb")
    assert s2["states"][verb]["cl0"].dtype == F64
    a_b, _, _ = stt.render(patch, 200, engine="block", device="cpu")
    a_s, _, _ = stt.render(patch, 200, engine="scan", device="cpu")
    torch.testing.assert_close(a_b, a_s, atol=5e-6, rtol=0)
    # render_long's carries, render_stream's blocks and a one-patch
    # render_many keep the f64 leaves and equal one render
    long_audio, long_state = stt.render_long(patch, 200, segment=64,
                                             device="cpu")
    torch.testing.assert_close(long_audio, a_s, atol=5e-6, rtol=0)
    assert long_state["states"][verb]["cl0"].dtype == F64
    blocks = [a for a, _, _ in stt.render_stream(
        patch, n_blocks=2, engine="block", device="cpu")]
    block = patch.config.block_size
    torch.testing.assert_close(torch.cat(blocks, dim=-1),
                               stt.render(patch, 2 * block, engine="block",
                                          device="cpu")[0],
                               atol=5e-6, rtol=0)
    many = stt.render_many([patch], 200, device="cpu")[0]
    torch.testing.assert_close(many, a_s, atol=5e-6, rtol=0)
    moved = stt.migrate_state(compiled, compiled, s1)
    assert moved["states"][verb]["cl0"].dtype == F64
    assert all(moved["states"][m]["pos"].dtype == F64
               for m in moved["states"] if "pos" in moved["states"][m]
               and compiled.instances[m][0].type_name == "Oscillator")


# -- the block forms ------------------------------------------------------------

@pytest.mark.parametrize("case", OSC_CASES)
def test_exact_osc_block_matches_jax(jax_ref, case):
    cfg = stt.AudioConfig(sample_rate=SR, precision="exact")
    statics = ("antialias", True)
    pre = f"osc_exact/{case}"
    state = _tree(jax_ref, f"{pre}/state")
    params = _tree(jax_ref, f"{pre}/params")
    assert state["pos"].dtype == F64
    cv = jax_ref.get(f"{pre}/cv")
    sync = jax_ref.get(f"{pre}/sync")
    ins = (None if cv is None else torch.from_numpy(cv),
           None if sync is None else torch.from_numpy(sync))
    if case == "free":
        params = {**params, **osc._osc_derive(cfg, statics, params,
                                              (False, False))}
    n = 300
    final, waves = osc._osc_block(cfg, statics, params, state, ins, None, n)
    got = torch.stack(waves, dim=1)
    want = torch.from_numpy(jax_ref[f"{pre}/waves"])
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    jfinal = _tree(jax_ref, f"{pre}/final")
    torch.testing.assert_close(final["pos"], jfinal["pos"], atol=1e-12,
                               rtol=0)
    assert torch.equal(final["sync_last"], jfinal["sync_last"])


def _fv_inputs(jax_ref):
    cfg = stt.AudioConfig(sample_rate=SR, channels=2, precision="exact")
    statics, _ = fv.FREEVERB.make(cfg)
    return (cfg, statics, _tree(jax_ref, "freeverb_exact/params"),
            _tree(jax_ref, "freeverb_exact/state"))


def test_exact_freeverb_step_matches_jax(jax_ref):
    cfg, statics, params, state = _fv_inputs(jax_ref)
    assert state["cl0"].dtype == F64 and state["cl0_fs"].dtype == F64
    lanes = torch.from_numpy(jax_ref["freeverb_exact/step/lanes"])
    s = {k: (a.clone() if a.dim() > 1 else a) for k, a in state.items()}
    outs = []
    for t in range(lanes.shape[-1]):
        s, (l_out, r_out) = fv._step(cfg, statics, params, s,
                                     [lanes[0, :, t], lanes[1, :, t]])
        assert l_out.dtype == torch.float32
        outs.append(torch.stack([l_out, r_out], dim=0))
    got = torch.stack(outs, dim=-1).transpose(0, 1)
    want = torch.from_numpy(jax_ref["freeverb_exact/step/audio"])
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    jfinal = _tree(jax_ref, "freeverb_exact/step/final")
    for k, w in jfinal.items():
        assert s[k].dtype == w.dtype, k
        if w.dtype == F64:
            torch.testing.assert_close(s[k], w, atol=1e-12, rtol=0)
        else:
            assert torch.equal(s[k], w), k


@pytest.mark.parametrize("n", [512, 300])
def test_exact_freeverb_block_matches_jax(jax_ref, n):
    cfg, statics, params, state = _fv_inputs(jax_ref)
    lanes = torch.from_numpy(jax_ref[f"freeverb_exact/block{n}/lanes"])
    autos = _tree(jax_ref, f"freeverb_exact/block{n}/autos")
    final, (l_out, r_out) = fv._block(cfg, statics, {**params, **autos},
                                      state, [lanes[0], lanes[1]], None, n)
    got = torch.stack([l_out, r_out], dim=1)
    want = torch.from_numpy(jax_ref[f"freeverb_exact/block{n}/audio"])
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    jfinal = _tree(jax_ref, f"freeverb_exact/block{n}/final")
    for k, w in jfinal.items():
        assert final[k].dtype == w.dtype, k
        torch.testing.assert_close(final[k], w, atol=1e-6 if w.dtype == F64
                                   else 0, rtol=0)


# -- partitions, precision drift, interop ---------------------------------------

@pytest.mark.parametrize("name", ["subtractive_voice", "feedback_patch",
                                  "reverb_patch", "drum_machine",
                                  "sampler_kit", "sequencer_patch"])
def test_exact_partition_equals_jax(name):
    """No synthesized seed, no absorption: the stage is the serial core;
    the JAX package has no Pallas stage in exact mode, the port runs it on
    K3 (``kernel_ok``) wherever every stage module has a device
    function."""
    kw = dict(sample_rate=SR, block_size=BLOCK, precision="exact",
              channels=2 if name == "reverb_patch" else 1)
    jprog = JaxBlockProgram(st.compile_patch(
        getattr(jpresets, name)(st.AudioConfig(**kw))))
    compiled = stt.compile_patch(getattr(stt.presets, name)(
        stt.AudioConfig(**kw)))
    tprog = compiled.block_program()
    for attr in ("pre_plan", "stage_plan", "post_plan", "stage_in",
                 "stage_out", "stage_fb_in"):
        assert getattr(tprog, attr) == list(getattr(jprog, attr)), attr
    assert not jprog.pallas_ok and tprog.kernel_ok
    assert not compiled.fused_eligible()
    assert compiled.auto_engine(True, "cuda") == "block"
    assert compiled.auto_engine(False, "cuda") == "block"
    assert compiled.auto_engine(True, "cpu") == "scan"
    types = [compiled.instances[m][0].type_name for m in tprog.stage_plan]
    want = {"subtractive_voice": ["Moog Filter", "ADSR"],
            "feedback_patch": ["Multiply", "Oscillator", "Multiply",
                               "Oscillator", "Mono Mixer", "Moog Filter"],
            "reverb_patch": ["Moog Filter", "ADSR"],
            "drum_machine": ["ADSR", "ADSR", "Moog Filter"]}
    if name in want:
        assert types == want[name]


def test_fast_vs_exact_one_second_drift():
    """``tests/test_precision.py``'s twin: a sine at val 0.25, 1 s at 48
    kHz, fast (int32 phase) against exact (f64 phase) within 1e-3, both
    through the block engine's whole-block oscillator on the CPU."""
    def sine(precision):
        p = stt.Patch(stt.AudioConfig(sample_rate=48000, block_size=1024,
                                      channels=1, precision=precision))
        o = p.add("Oscillator", val=0.25)
        p.connect(o, "Sine", p.output, 0)
        return stt.render(p, 48000, engine="block", device="cpu")[0][0]
    fast, exact = sine("fast"), sine("exact")
    assert (fast - exact).abs().max() < 1e-3
    assert exact.abs().max() > 0.99


def test_voice_drift_between_precisions_is_the_reference_s(jax_ref):
    """subtractive_voice at 4,800 Hz, 2 voices, 1 s: the port's fast and
    exact renders (block engine on the CPU) equal JAX's scan renders
    within the block tolerance, so their difference is JAX's to within
    1e-5.  (At 48 kHz the same voice's fast and exact renders differ by a
    few 1e-3: the phase error of the f32 increment, amplified at the saw's
    steps and the gate's edges; chip_smoke.py phase 17 reports it.)"""
    out = {}
    for precision in ("fast", "exact"):
        patch = stt.presets.subtractive_voice(stt.AudioConfig(
            sample_rate=SR, block_size=BLOCK, channels=1,
            precision=precision))
        out[precision] = stt.render_batch(
            patch, SR, params=stt.presets.farm_params(patch, 2),
            engine="block", device="cpu")[0]
        want = torch.from_numpy(jax_ref[f"drift/{precision}"])
        torch.testing.assert_close(out[precision], want, atol=5e-6, rtol=0)
    drift = out["fast"] - out["exact"]
    jdrift = torch.from_numpy(jax_ref["drift/fast"] - jax_ref["drift/exact"])
    torch.testing.assert_close(drift, jdrift, atol=1e-5, rtol=0)
    assert drift.abs().max() > 1e-6


DRIFT48_WINDOW = (12288, 13312)   # the worker's cuts


def test_voice_drift_at_48khz_is_the_reference_s(jax_ref):
    """subtractive_voice at 48 kHz, 4 voices of farm_params, 1 s: JAX's
    own fast and exact scan renders differ by more than 1e-3 (so
    ``tests/test_precision.py``'s 1e-3, which holds for its sine, does not
    hold for this voice in the reference).  The port, started from JAX's
    state of each precision at sample 12,288, renders the 1,024 samples in
    which the first of these voices drifts past 1e-3 within 5e-6 of JAX's
    (its block engine on the CPU), so its drift there is JAX's to within
    1e-5."""
    w0, w1 = DRIFT48_WINDOW
    jaudio = {p: jax_ref[f"drift48/{p}/audio"] for p in ("fast", "exact")}
    jdrift = jaudio["fast"] - jaudio["exact"]
    assert jaudio["exact"].shape == (4, 1, 48000)
    assert np.abs(jdrift).max() > 1e-3
    assert np.abs(jdrift[..., :w0]).max() <= 1e-3
    out = {}
    for precision in ("fast", "exact"):
        patch = stt.presets.subtractive_voice(stt.AudioConfig(
            sample_rate=48000, channels=1, precision=precision))
        compiled = stt.compile_patch(patch)
        state = _tree(jax_ref, f"drift48/{precision}/state")
        state = {"states": {m: state["states"].get(m, {})
                            for m in compiled.instances}, "fb": {}}
        out[precision] = compiled.render(
            w1 - w0, params=stt.presets.farm_params(patch, 4), state=state,
            batched=True, engine="block", device="cpu")[0]
        want = torch.from_numpy(jaudio[precision][..., w0:w1])
        torch.testing.assert_close(out[precision], want, atol=5e-6, rtol=0)
    drift = out["fast"] - out["exact"]
    torch.testing.assert_close(drift, torch.from_numpy(jdrift[..., w0:w1]),
                               atol=1e-5, rtol=0)
    assert drift.abs().max() > 1e-3


def test_jax_exact_state_round_trips_through_interop():
    jpatch = jpresets.reverb_patch(st.AudioConfig(
        sample_rate=SR, channels=2, precision="exact"))
    jc = st.compile_patch(jpatch)
    _, _, jstate = jc.render(96, engine="scan")
    arrays = jax.tree.map(np.asarray, jstate)
    state = interop.state_from_numpy(arrays)
    verb = next(i.id for i in jpatch if i.mdef.type_name == "Freeverb")
    osc_id = next(i.id for i in jpatch if i.mdef.type_name == "Oscillator")
    assert state["states"][verb]["cl0"].dtype == F64
    assert state["states"][osc_id]["pos"].dtype == F64
    back = interop.to_numpy(state)
    for mid, sd in arrays["states"].items():
        for k, a in sd.items():
            assert back["states"][mid][k].dtype == a.dtype, (mid, k)
            np.testing.assert_array_equal(back["states"][mid][k], a)
    # and JAX renders on from it
    audio, _, _ = jc.render(32, state=jax.tree.map(jnp.asarray, back),
                            engine="scan")
    assert np.isfinite(np.asarray(audio)).all()
