"""The port's render statistics, numerical guards and voice allocation
(the twins of ``tests/test_utils.py``'s ``timed_render``,
``check_finite``, ``quarantine_batch`` and ``recompile_guard`` cases and of
``tests/test_notes.py``'s two ``allocate_voices`` cases), on the CPU."""

import pytest
import torch

from srack_tpu.utils.notes import allocate_voices as jax_allocate_voices

import srack_tpu_torch as stt
from srack_tpu_torch.ops import cuda_lib
from srack_tpu_torch.utils.debug import (NonFiniteAudio, check_finite,
                                         quarantine_batch, recompile_guard)
from srack_tpu_torch.utils.notes import allocate_voices
from srack_tpu_torch.utils.profiling import RenderStats, timed_render, trace

CFG = stt.AudioConfig(sample_rate=4800, block_size=64, channels=1,
                      precision="exact")


def test_timed_render_stats():
    compiled = stt.compile_patch(stt.presets.subtractive_voice(CFG))
    audio, _, _, stats = timed_render(compiled, 256, device="cpu")
    assert isinstance(stats, RenderStats)
    assert stats.n_samples == 256 and stats.n_voices == 1
    assert stats.channels == 1 and stats.sample_rate == 4800
    assert stats.samples_per_sec > 0 and stats.nan_lanes == 0
    assert stats.peak_amplitude == pytest.approx(float(audio.abs().max()))
    _, _, _, batch = timed_render(
        compiled, 64, device="cpu", batched=True,
        params=stt.replicate_params(compiled.default_params, 3))
    assert batch.n_voices == 3 and batch.as_dict()["realtime_factor"] > 0


def test_trace_records_the_span(tmp_path):
    compiled = stt.compile_patch(stt.presets.sine_patch(CFG))
    with trace("sine_render", trace_dir=str(tmp_path)) as prof:
        compiled.render(32, device="cpu")
    names = {e.key for e in prof.key_averages()}
    assert "sine_render" in names
    assert (tmp_path / "sine_render.json").stat().st_size > 0


def test_check_finite_passes_healthy_patch():
    _, probe_vals, _ = check_finite(stt.presets.subtractive_voice(CFG), 128,
                                    device="cpu")
    assert len(probe_vals) > 5  # every port probed


def test_check_finite_catches_blowup():
    p = stt.Patch(CFG)
    osc = p.add("Oscillator", val=5.0)
    nl = p.add("Non-Linear", constant=200.0)
    big = p.add("Multiply", constant=1e30)
    p.connect(osc, "Sine", big, "In1")
    p.connect(big, 0, nl, "In1")
    nl2 = p.add("Multiply", constant=1e30)
    p.connect(nl, 0, nl2, "In1")
    p.connect(nl2, 0, p.output, 0)
    with pytest.raises(NonFiniteAudio, match=nl.id):
        check_finite(p, 64, device="cpu")


def test_quarantine_batch():
    audio = torch.ones((3, 1, 16))
    audio[1, 0, 5] = float("nan")
    clean, ok = quarantine_batch(audio)
    assert ok.tolist() == [True, False, True]
    assert float(clean[1].sum()) == 0.0
    assert bool(torch.isfinite(clean).all())
    torch.testing.assert_close(clean[0], audio[0])


def test_recompile_guard():
    p = stt.presets.sine_patch(CFG)
    compiled = stt.compile_patch(p)
    compiled.render(64, device="cpu")  # warm
    with recompile_guard():
        compiled.render(64, device="cpu")
    osc = [i.id for i in p if i.mdef.type_name == "Oscillator"][0]
    p.set_params(osc, val=1.0)
    with recompile_guard():
        stt.render(p, 64, device="cpu")  # a param edit reuses the plan
    q = stt.Patch(CFG)
    q.connect(q.add("Oscillator", val=0.375), "Square", q.output, 0)
    with pytest.raises(AssertionError, match="compiled plan"):
        with recompile_guard():
            stt.render(q, 8, device="cpu")  # a new topology
    try:
        with pytest.raises(AssertionError, match="nvcc"):
            with recompile_guard():
                cuda_lib.EVENTS["nvcc"] += 1  # what a kernel build records
    finally:
        cuda_lib.EVENTS["nvcc"] -= 1


def test_allocate_voices_spreads_chord():
    chord = [("C4", 0.0, 1.0), ("E4", 0.0, 1.0), ("G4", 0.0, 1.0)]
    lanes = allocate_voices(chord, 4)
    assert lanes == jax_allocate_voices(chord, 4)
    assert sorted(len(lane) for lane in lanes) == [0, 1, 1, 1]
    melody = [("C4", 0.0, 0.4), ("D4", 0.5, 0.4), ("E4", 1.0, 0.4)]
    assert sum(len(lane) for lane in allocate_voices(melody, 2)) == 3


def test_allocate_voices_steals_oldest_and_truncates():
    ev = [("C4", 0.0, 10.0), ("E4", 0.1, 10.0), ("G4", 0.2, 10.0)]
    lanes = allocate_voices(ev, 2)
    assert lanes == jax_allocate_voices(ev, 2)
    c4 = [e for lane in lanes for e in lane
          if abs(e[1]) < 1e-9 and e[0] == "C4"][0]
    assert abs(c4[2] - 0.2) < 1e-9
    assert sum(len(lane) for lane in lanes) == 3
