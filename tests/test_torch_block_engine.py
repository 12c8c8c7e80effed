"""The port's block engine against the JAX package's, on the CPU.

* **Partition.**  ``BlockProgram`` equals the JAX package's, list for list
  (pre, stage and post plans, stage inputs, outputs and feedback inputs,
  and whether the stage can run on the stage kernel), for sine_patch,
  subtractive_voice, feedback_patch, reverb_patch, block_check_patch,
  drum_machine, sampler_kit and kit_check_patch, with and without buffer
  feedback.
* **``_osc_block``** against the JAX ``_osc_block``, free-running, with a
  CV, a Sync, both, and an automated ``val``: waves and int32/bool state
  exact, the float phase shadow ``pos_g`` within ``rtol=1e-5`` (an f32 sum
  in another order).
* **The block engine** (``engine="block"`` on CPU tensors: its kernels'
  plain versions) on reverb_patch and block_check_patch (automated
  ``room_size`` and ``wet``) against the JAX block engine at n = 512: audio
  and float state within ``5e-6`` (``tests/test_block_engine.py``), int32
  and bool state exact; and against the port's scan engine.
* **The stage loop** (kernel K3's plain version) against the JAX package's
  K3 in interpret mode (``make_serial_kernel``, t_chunk=64, unroll=4) at
  n = 70 (ragged) and 64: bit-exact.
* **The slice-3b patches** (drum_machine, sampler_kit, kit_check_patch,
  from random sequencer steps and Sample positions; drum_machine's Noise
  fed one numpy lane in both packages) on the block engine against the
  JAX block engine and against the port's scan engine at n = 512:
  ``5e-6``, and exact in fact.
* **Buffer-feedback mode** (block 64, n = 512) against the JAX block
  engine's on feedback_patch, drum_machine and reverb_patch: audio and the
  final ``fb`` within ``5e-6``; a render continued from the carried state
  equals one render.
* **Segments, probes, unbatched renders, engine choice**, and the
  sequencer patch and buffer mode, which raised before slice 3b, against
  the scan engine.

The JAX renders come from ``tests/torch_parity_worker.py`` (its own
process, ``--xla_cpu_max_isa=AVX``); the partitions are pure Python and
are built here.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import srack_tpu as st
from srack_tpu import presets as jpresets
from srack_tpu.block_engine import BlockProgram as JaxBlockProgram

import srack_tpu_torch as stt
from srack_tpu_torch import interop
from srack_tpu_torch.block_engine import BlockProgram
from srack_tpu_torch.modules import oscillator as osc
from srack_tpu_torch.ops.ring_roll import ring_align_plain

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_parity_worker.py"
ATOL = 5e-6
CASES = ("reverb_patch", "block_check_patch")
KIT_CASES = ("drum_machine", "sampler_kit", "kit_check_patch")
BUFFER_CASES = ("feedback_patch", "drum_machine", "reverb_patch")
OSC_CASES = ("free", "cv", "sync", "cv_sync", "auto_val")


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run(
        [sys.executable, str(WORKER), str(out), "osc_block",
         *[f"{c}@block" for c in CASES + KIT_CASES],
         *[f"{c}@buffer" for c in BUFFER_CASES]],
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


def _state(tree: dict, compiled) -> dict:
    """npz keeps no empty dicts: restore stateless modules and the fb."""
    return {"states": {m: tree.get("states", {}).get(m, {})
                       for m in compiled.instances},
            "fb": tree.get("fb", {})}


def _params(tree: dict, compiled) -> dict:
    return {m: tree.get(m, {}) for m in compiled.instances}


def _cfg(pkg, name, **kw):
    return pkg.AudioConfig(sample_rate=4800, block_size=64,
                           channels=2 if name == "reverb_patch" else 1,
                           precision="fast", **kw)


def _port_case(name, **kw):
    """``(patch, automation)`` of a case built with the port."""
    cfg = _cfg(stt, name, **kw)
    if name == "block_check_patch":
        return stt.presets.block_check_patch(cfg)
    return getattr(stt.presets, name)(cfg), ()


def _jax_case(name, **kw):
    cfg = _cfg(st, name, **kw)
    if name == "block_check_patch":
        return stt.presets.block_check_patch(cfg, patch_cls=st.Patch)
    if name == "kit_check_patch":
        return stt.presets.kit_check_patch(cfg, patch_cls=st.Patch), ()
    return getattr(jpresets, name)(cfg), ()


def _canonical(state: dict, compiled) -> dict:
    """Every Freeverb ring in time order (write index 0): the scan engine
    keeps rings, the block engine returns them in time order."""
    out = {"states": {}, "fb": state["fb"]}
    for mid, sd in state["states"].items():
        sd = dict(sd)
        if compiled.instances[mid][0].type_name == "Freeverb":
            for k in [k for k in sd if f"{k}_idx" in sd]:
                sd[k] = ring_align_plain(sd[k], sd[f"{k}_idx"])
                sd[f"{k}_idx"] = torch.zeros_like(sd[f"{k}_idx"])
        out["states"][mid] = sd
    return out


def assert_state_close(got, want, where, skip=()):
    """int32 and bool leaves exact, float leaves within ATOL."""
    assert set(got["states"]) == set(want["states"]), where
    assert set(got["fb"]) == set(want["fb"]), where
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
                torch.testing.assert_close(g, w, atol=ATOL, rtol=0,
                                           msg=f"{where} {mid}.{k}")
    for k, w in want["fb"].items():
        torch.testing.assert_close(got["fb"][k], w, atol=ATOL, rtol=0)


# -- partition ---------------------------------------------------------------

@pytest.mark.parametrize("buffer_feedback", [False, True])
@pytest.mark.parametrize("name", ["sine_patch", "subtractive_voice",
                                  "feedback_patch", "reverb_patch",
                                  "block_check_patch", *KIT_CASES])
def test_partition_equals_jax(name, buffer_feedback):
    jpatch, jautos = _jax_case(name, buffer_feedback=buffer_feedback)
    tpatch, tautos = _port_case(name, buffer_feedback=buffer_feedback)
    jprog = JaxBlockProgram(st.compile_patch(jpatch, automation=jautos))
    tprog = BlockProgram(stt.compile_patch(tpatch, automation=tautos))
    for attr in ("pre_plan", "stage_plan", "post_plan", "stage_in",
                 "stage_out", "stage_fb_in"):
        assert getattr(tprog, attr) == list(getattr(jprog, attr)), attr
    assert tprog.kernel_ok == jprog.pallas_ok
    assert tprog._outs_used == jprog._outs_used


def test_partition_of_the_slice_patches():
    """reverb_patch's stage absorbs the whole voice and sends one wire to
    the Freeverb; block_check_patch's pre phase holds the LFO, the
    Multiply, the VCO and the Freeverb, its stage the clock, the ADSR, the
    filter and the VCA, fed by the Freeverb's Left."""
    patch, _ = _port_case("reverb_patch")
    prog = stt.compile_patch(patch).block_program()
    names = {i.id: i.name for i in patch}
    assert prog.pre_plan == []
    assert [names[m] for m in prog.post_plan] == ["verb", None]
    assert [names[s] for s, _ in prog.stage_out] == ["vca"]
    patch, autos = _port_case("block_check_patch")
    prog = stt.compile_patch(patch, automation=autos).block_program()
    names = {i.id: i.name for i in patch}
    assert [names[m] for m in prog.pre_plan] == ["lfo", "lfo_depth", "vco",
                                                 "verb"]
    assert sorted(names[m] for m in prog.stage_plan) == ["clock", "env",
                                                         "vca", "vcf"]
    assert [(names[s], p) for s, p in prog.stage_in] == [("verb", 0)]
    verb = next(i.id for i in patch if i.name == "verb")
    assert prog._outs_used[verb] == (True, False)  # Right feeds nothing


# -- _osc_block --------------------------------------------------------------

@pytest.mark.parametrize("case", OSC_CASES)
def test_osc_block_matches_jax(jax_ref, case):
    cfg = stt.AudioConfig(sample_rate=4800)
    statics = ("antialias", True)
    state = _tree(jax_ref, f"osc_block/{case}/state")
    params = _tree(jax_ref, f"osc_block/{case}/params")
    if case == "free":
        params.update(osc._osc_derive(cfg, statics, params, (False, False)))
    cv = jax_ref.get(f"osc_block/{case}/cv")
    sync = jax_ref.get(f"osc_block/{case}/sync")
    ins = tuple(None if a is None else torch.from_numpy(a)
                for a in (cv, sync))
    n = jax_ref[f"osc_block/{case}/waves"].shape[-1]
    final, waves = osc.OSCILLATOR.block(cfg, statics, params, state, ins,
                                        None, n)
    np.testing.assert_array_equal(torch.stack(waves, dim=1).numpy(),
                                  jax_ref[f"osc_block/{case}/waves"])
    want = _tree(jax_ref, f"osc_block/{case}/final")
    assert torch.equal(final["pos"], want["pos"])
    assert torch.equal(final["sync_last"], want["sync_last"])
    torch.testing.assert_close(final["pos_g"], want["pos_g"], rtol=1e-5,
                               atol=0)


def test_osc_block_equals_the_step():
    """The whole-block phases are the per-sample step's, bit for bit."""
    cfg = stt.AudioConfig(sample_rate=4800)
    statics = ("antialias", True)
    rng = np.random.default_rng(4)
    v, n = 3, 200
    state = {"pos": torch.from_numpy(rng.integers(
                -2 ** 31, 2 ** 31 - 1, v, dtype=np.int64).astype(np.int32)),
             "pos_g": torch.zeros(v), "sync_last": torch.ones(v, dtype=bool)}
    params = {"val": torch.from_numpy(rng.uniform(-3, 0, v).astype(
        np.float32))}
    cv = torch.from_numpy(rng.uniform(-1, 1, (v, n)).astype(np.float32))
    sync = torch.from_numpy(np.where(rng.uniform(size=(v, n)) < 0.05, 1.0,
                                     -1.0).astype(np.float32))
    final, waves = osc.OSCILLATOR.block(cfg, statics, params, state,
                                        (cv, sync), None, n)
    s, want = state, []
    for t in range(n):
        s, o = osc.OSCILLATOR.step_nograd(cfg, statics, params, s,
                                          (cv[:, t], sync[:, t]))
        want.append(torch.stack(o, dim=1))
    assert torch.equal(torch.stack(waves, dim=1), torch.stack(want, dim=-1))
    assert torch.equal(final["pos"], s["pos"])
    assert torch.equal(final["sync_last"], s["sync_last"])
    torch.testing.assert_close(final["pos_g"], s["pos_g"], rtol=1e-5,
                               atol=1e-6)


# -- the block engine --------------------------------------------------------

def _inputs(jax_ref, name, mode="block"):
    """``(patch, compiled, params, state, automation, tag)`` of a case from
    the worker's saved inputs; ``automation`` also holds the Noise driver
    lanes, keyed by module id."""
    patch, autos = _port_case(name, buffer_feedback=mode == "buffer")
    compiled = stt.compile_patch(patch, automation=autos)
    tag = f"{name}@{mode}"
    assert list(compiled.plan) == list(jax_ref[f"{tag}/plan"])
    params = _params(_tree(jax_ref, f"{tag}/params"), compiled)
    state = _state(_tree(jax_ref, f"{tag}/state"), compiled)
    drivers = _tree(jax_ref, f"{tag}/drivers")
    automation = {tuple(k.split("~")) if "~" in k else k: a
                  for k, a in drivers.items()}
    return patch, compiled, params, state, automation, tag


def _render(compiled, n, params, state, lanes, **kw):
    """A batched CPU render with ``lanes`` split into automation arrays
    (keyed ``(mid, param)``) and driver lanes (keyed by module id)."""
    return compiled.render(
        n, params=params, state=state, batched=True, device="cpu",
        automation={k: a for k, a in lanes.items() if isinstance(k, tuple)},
        drivers={k: a for k, a in lanes.items() if isinstance(k, str)}, **kw)


@pytest.mark.parametrize("name", CASES)
def test_block_engine_matches_jax_block_engine(jax_ref, name):
    patch, compiled, params, state, automation, tag = _inputs(jax_ref, name)
    n = jax_ref[f"{tag}/block512/audio"].shape[-1]
    audio, _, final = compiled.render(n, params=params, state=state,
                                      automation=automation, batched=True,
                                      engine="block", device="cpu")
    np.testing.assert_allclose(audio.numpy(),
                               jax_ref[f"{tag}/block512/audio"], atol=ATOL,
                               rtol=0)
    want = _state(_tree(jax_ref, f"{tag}/block512/final"), compiled)
    assert_state_close(final, want, f"{name} block")


@pytest.mark.parametrize("name", CASES)
def test_block_engine_matches_port_scan_engine(jax_ref, name):
    """Against the scan engine on the same inputs.  The Freeverb's
    ``room_size`` lane is left out: the block form holds it per chunk where
    the step reads it per sample (the JAX package's documented
    approximation); ``wet`` is exact per sample in both."""
    patch, compiled, params, state, automation, tag = _inputs(jax_ref, name)
    automation = {k: a for k, a in automation.items() if k[1] != "room_size"}
    n = 300
    automation = {k: a[:, :n] for k, a in automation.items()}
    kw = dict(params=params, state=state, automation=automation,
              batched=True, device="cpu")
    audio_b, _, final_b = compiled.render(n, engine="block", **kw)
    audio_s, _, final_s = compiled.render(n, engine="scan", **kw)
    torch.testing.assert_close(audio_b, audio_s, atol=ATOL, rtol=0)
    # the step writes False to an oscillator's Sync edge state when its
    # Sync is unconnected, the block form keeps it (never read); the float
    # phase shadow is an f32 sum in another order
    skip = {(m, k) for m, (mdef, _, ins) in compiled.instances.items()
            if mdef.type_name == "Oscillator"
            for k in (["pos_g"] + (["sync_last"] if ins[1] is None else []))}
    assert_state_close(_canonical(final_b, compiled),
                       _canonical(final_s, compiled), f"{name} scan", skip)
    for m, k in skip:
        if k == "pos_g":
            torch.testing.assert_close(final_b["states"][m][k],
                                       final_s["states"][m][k], rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("name", ["sine_patch", "subtractive_voice",
                                  "feedback_patch"])
def test_block_engine_matches_scan_engine_on_fused_presets(name):
    """The presets the fused kernel takes run on the block engine too: no
    stage (sine), the whole voice absorbed (subtractive), feedback carries
    inside the stage (feedback)."""
    patch, _ = _port_case(name)
    compiled = stt.compile_patch(patch)
    params = stt.presets.farm_params(patch, 3)
    kw = dict(params=params, batched=True, device="cpu")
    audio_b, _, final_b = compiled.render(300, engine="block", **kw)
    audio_s, _, final_s = compiled.render(300, engine="scan", **kw)
    torch.testing.assert_close(audio_b, audio_s, atol=ATOL, rtol=0)
    skip = {(m, k) for m, (mdef, _, ins) in compiled.instances.items()
            if mdef.type_name == "Oscillator"
            for k in (["pos_g"] + (["sync_last"] if ins[1] is None else []))}
    assert_state_close(final_b, final_s, f"{name} scan", skip)


@pytest.mark.parametrize("n", [70, 64])
@pytest.mark.parametrize("name", CASES)
def test_stage_loop_matches_jax_k3_interpret(jax_ref, name, n):
    patch, compiled, params, state, _, tag = _inputs(jax_ref, name)
    prog = compiled.block_program()
    derived = compiled.derived_params(params)
    lanes = {k: a for k, a in _tree(jax_ref, f"{tag}/k3_{n}/lanes").items()}
    stage_state = {"states": {m: state["states"][m]
                              for m in prog.stage_plan}, "fb": state["fb"]}
    outs, final = prog.stage_plain({m: derived[m] for m in prog.stage_plan},
                                   stage_state, lanes, n)
    want = _tree(jax_ref, f"{tag}/k3_{n}/outs")
    assert sorted(want) == sorted(f"{s}#{p}" for s, p in outs)
    for (s, p), got in outs.items():
        assert torch.equal(got, want[f"{s}#{p}"]), (s, p)
    want_final = _tree(jax_ref, f"{tag}/k3_{n}/final")
    for mid in prog.stage_plan:
        for k, w in want_final.get("states", {}).get(mid, {}).items():
            assert torch.equal(final["states"][mid][k], w), (mid, k)


@pytest.mark.parametrize("name", CASES)
def test_block_engine_segments_equal_one_render(name):
    """``render(n, segment=s)`` equals one render.  Only ``wet`` is
    automated: a held ``room_size`` snapshots at chunk starts, which a
    segment boundary moves."""
    patch, autos = _port_case(name)
    compiled = stt.compile_patch(patch, automation=autos)
    params = stt.presets.farm_params(patch, 3)
    rng = np.random.default_rng(8)
    n = 384
    automation = {a: torch.from_numpy(rng.uniform(0.2, 0.8, (3, n)).astype(
        np.float32)) for a in autos if a[1] == "wet"}
    kw = dict(params=params, automation=automation, batched=True,
              engine="block", device="cpu")
    whole, _, s_whole = compiled.render(n, **kw)
    pieces, _, s_pieces = compiled.render(n, segment=128, **kw)
    torch.testing.assert_close(pieces, whole, atol=ATOL, rtol=0)
    assert_state_close(s_pieces, s_whole, f"{name} segments")


def test_block_engine_probes_and_unbatched_render():
    patch, _ = _port_case("reverb_patch")
    ids = {i.name: i.id for i in patch}
    probes = [(ids["env"], 0), (ids["verb"], "Right"), (ids["lfo"], "Sine")]
    audio_b, probes_b, _ = stt.render(patch, 200, probes=probes,
                                      engine="block", device="cpu")
    audio_s, probes_s, _ = stt.render(patch, 200, probes=probes,
                                      engine="scan", device="cpu")
    assert tuple(audio_b.shape) == (2, 200)
    torch.testing.assert_close(audio_b, audio_s, atol=ATOL, rtol=0)
    assert set(probes_b) == set(probes_s) and len(probes_b) == 3
    for k, w in probes_s.items():
        torch.testing.assert_close(probes_b[k], w, atol=ATOL, rtol=0)


# -- engine choice -----------------------------------------------------------

def test_engine_choice():
    """On CUDA tensors, batched or one unbatched voice: fused when
    eligible, else block when eligible, else scan; on the CPU the scan
    engine.  Pure logic: no card is needed to ask."""
    reverb = stt.compile_patch(_port_case("reverb_patch")[0])
    assert not reverb.fused_eligible() and reverb.block_eligible()
    assert reverb.auto_engine(True, "cuda") == "block"
    assert reverb.auto_engine(False, "cuda") == "block"
    assert reverb.auto_engine(False, "cpu") == "scan"
    assert reverb.auto_engine(True, "cpu") == "scan"
    voice = stt.compile_patch(_port_case("subtractive_voice")[0])
    assert voice.auto_engine(True, "cuda") == "fused"
    patch, autos = _port_case("block_check_patch")
    assert stt.compile_patch(patch, automation=autos).auto_engine(
        True, "cuda") == "block"
    # a Sample patch whose stage K3 can run takes the block engine, in
    # either feedback mode; the fused kernel keeps what it can take
    for name in KIT_CASES:
        compiled = stt.compile_patch(_port_case(name)[0])
        assert not compiled.fused_eligible()
        assert compiled.auto_engine(True, "cuda") == "block", name
    drums = stt.compile_patch(_port_case("drum_machine",
                                         buffer_feedback=True)[0])
    assert drums.auto_engine(True, "cuda") == "block"
    seq = stt.compile_patch(_port_case("sequencer_patch")[0])
    assert seq.auto_engine(True, "cuda") == "fused"
    fb = stt.compile_patch(_port_case("feedback_patch",
                                      buffer_feedback=True)[0])
    assert fb.auto_engine(True, "cuda") == "fused"
    # a Sample inside the serial stage (on a feedback cycle): K3 cannot run
    # it, so the scan engine
    p = stt.Patch(stt.AudioConfig(sample_rate=4800, channels=1))
    smp = p.add("Sample", samples=np.ones(64, np.float32),
                wav_sample_rate=4800)
    flt = p.add("Moog Filter")
    p.connect(smp, 0, flt, "Audio")
    p.connect(flt, 0, smp, "Gate")
    p.connect(flt, 0, p.output, 0)
    loop = stt.compile_patch(p)
    assert not loop.block_eligible()
    assert loop.auto_engine(True, "cuda") == "scan"


def test_unported_block_forms_raise_and_name_the_roadmap():
    """Slice 3b ported what this test once saw raise: the sequencers'
    block forms (sequencer_patch under ``engine="block"``) and buffer
    mode (reverb_patch with ``buffer_feedback=True``).  Both now render on
    the block engine and equal the scan engine within 5e-6."""
    seq = stt.presets.sequencer_patch(_cfg(stt, "sequencer_patch"))
    compiled = stt.compile_patch(seq)
    assert compiled.block_eligible()
    assert compiled.auto_engine(True, "cuda") == "fused"
    params = stt.presets.farm_params(seq, 2)
    kw = dict(params=params, batched=True, device="cpu")
    audio_b, _, _ = compiled.render(700, engine="block", **kw)
    audio_s, _, _ = compiled.render(700, engine="scan", **kw)
    torch.testing.assert_close(audio_b, audio_s, atol=ATOL, rtol=0)
    assert audio_s.abs().max() > 0.01
    patch, _ = _port_case("reverb_patch", buffer_feedback=True)
    compiled = stt.compile_patch(patch)
    assert compiled.block_eligible()
    assert compiled.auto_engine(True, "cuda") == "block"
    params = stt.presets.farm_params(patch, 2)
    kw = dict(params=params, batched=True, device="cpu")
    audio_b, _, _ = compiled.render(192, engine="block", **kw)
    audio_s, _, _ = compiled.render(192, engine="scan", **kw)
    torch.testing.assert_close(audio_b, audio_s, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="whole blocks"):
        compiled.render(100, engine="block", **kw)


def test_state_of_a_block_render_crosses_to_jax():
    """A block render's final state (Freeverb rings in time order) is a
    state both packages take."""
    patch, _ = _port_case("reverb_patch")
    _, _, final = stt.render(patch, 64, engine="block", device="cpu")
    arrays = interop.to_numpy(final)
    verb = next(i.id for i in patch if i.name == "verb")
    assert arrays["states"][verb]["cl0"].dtype == np.float32
    assert arrays["states"][verb]["cl0_idx"].dtype == np.int32
    jpatch, _ = _jax_case("reverb_patch")
    jcompiled = st.compile_patch(jpatch)
    audio, _, _ = jcompiled.render(32, state=arrays, engine="scan")
    assert np.isfinite(np.asarray(audio)).all()


# -- slice 3b: the kit patches and buffer mode -------------------------------

@pytest.mark.parametrize("name", KIT_CASES)
def test_kit_block_engine_matches_jax_and_scan(jax_ref, name):
    patch, compiled, params, state, lanes, tag = _inputs(jax_ref, name)
    n = jax_ref[f"{tag}/block512/audio"].shape[-1]
    audio, _, final = _render(compiled, n, params, state, lanes,
                              engine="block")
    want = jax_ref[f"{tag}/block512/audio"]
    np.testing.assert_allclose(audio.numpy(), want, atol=ATOL, rtol=0)
    assert np.abs(want).max() > 0.01  # the Samples and voices sound
    assert_state_close(final, _state(_tree(jax_ref, f"{tag}/block512/final"),
                                     compiled), f"{name} block")
    audio_s, _, final_s = _render(compiled, n, params, state, lanes,
                                  engine="scan")
    torch.testing.assert_close(audio, audio_s, atol=ATOL, rtol=0)
    skip = {(m, k) for m, (mdef, _, ins) in compiled.instances.items()
            if mdef.type_name == "Oscillator"
            for k in (["pos_g"] + (["sync_last"] if ins[1] is None else []))}
    assert_state_close(final, final_s, f"{name} scan", skip)
    # every Sample played: its position moved or it restarted
    for mid, (mdef, _, _) in compiled.instances.items():
        if mdef.type_name == "Sample":
            assert not torch.equal(final["states"][mid]["pos"],
                                   state["states"][mid]["pos"]), mid


@pytest.mark.parametrize("name", BUFFER_CASES)
def test_buffer_mode_matches_jax_block_engine(jax_ref, name):
    patch, compiled, params, state, lanes, tag = _inputs(jax_ref, name,
                                                         "buffer")
    n = jax_ref[f"{tag}/block512/audio"].shape[-1]
    audio, _, final = _render(compiled, n, params, state, lanes,
                              engine="block")
    np.testing.assert_allclose(audio.numpy(),
                               jax_ref[f"{tag}/block512/audio"], atol=ATOL,
                               rtol=0)
    want = _state(_tree(jax_ref, f"{tag}/block512/final"), compiled)
    assert_state_close(final, want, f"{name} buffer")
    assert all(tuple(f.shape) == (4, 64) for f in final["fb"].values())
    # continued from the carried state: two halves equal one render
    h = n // 2
    first = {k: a[..., :h] for k, a in lanes.items()}
    second = {k: a[..., h:] for k, a in lanes.items()}
    a1, _, s1 = _render(compiled, h, params, state, first, engine="block")
    a2, _, s2 = _render(compiled, n - h, params, s1, second,
                        engine="block")
    torch.testing.assert_close(torch.cat([a1, a2], dim=-1), audio,
                               atol=ATOL, rtol=0)
    assert_state_close(s2, final, f"{name} buffer halves")


def test_sample_state_crosses_to_jax():
    """A sampler_kit render's final state (Sample positions, playing and
    gate edge flags) and its params, tables included, carry into the JAX
    package, whose render from them equals the port's continued render."""
    patch, _ = _port_case("sampler_kit")
    params = stt.presets.farm_params(patch, 2)
    _, _, final = stt.render_batch(patch, 320, params=params,
                                   engine="block", device="cpu")
    arrays = interop.to_numpy(final)
    smp = next(i.id for i in patch if i.name == "kick")
    assert arrays["states"][smp]["playing"].dtype == np.bool_
    assert arrays["states"][smp]["pos"].dtype == np.float32
    jpatch, _ = _jax_case("sampler_kit")
    jcompiled = st.compile_patch(jpatch)
    want, _, _ = jcompiled.render(256, params=interop.to_numpy(params),
                                  state=arrays, batched=True, engine="scan")
    got, _, _ = stt.render_batch(patch, 256, params=params, state=final,
                                 engine="block", device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
