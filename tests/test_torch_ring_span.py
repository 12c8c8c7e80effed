"""K2's feedback ring in the port's spans and counters, on the CPU.

``FusedKernel.operands`` packs the ring and ``FusedKernel.finish``
unpacks it, each inside a ``srk.ring`` span in buffer mode only (in
``srk.finish`` for the second; ``srk.pack`` holds the first on the card),
and only while a profiler records.  ``FusedKernel.ring_words`` is the
ring's words a voice: a block of each feedback key, 0 outside buffer
mode."""

import pytest
import torch

import srack_tpu_torch as stt
from srack_tpu_torch.ops import fused
from srack_tpu_torch.utils import profiling

from test_torch_spans import _profile


def _kernel(buffer: bool, block: int = 1024):
    cfg = stt.AudioConfig(sample_rate=48000, block_size=block, channels=1,
                          buffer_feedback=buffer)
    patch = (stt.presets.feedback_patch(cfg) if buffer
             else stt.presets.subtractive_voice(cfg))
    compiled = stt.compile_patch(patch)
    return compiled, fused.FusedKernel(compiled), patch


def _pack_and_finish(buffer: bool, voices: int = 3, block: int = 64):
    """The kernel's operands of one render and its final state from them,
    on the CPU (the launch itself needs the card)."""
    compiled, kernel, patch = _kernel(buffer, block)
    params = {mid: {k: t.to("cpu") for k, t in pd.items()} for mid, pd in
              stt.presets.farm_params(patch, voices).items()}
    state = compiled.init_state()
    state = {"states": {m: {k: torch.stack([a] * voices)
                            for k, a in sd.items()}
                        for m, sd in state["states"].items()},
             "fb": {k: torch.stack([a] * voices)
                    for k, a in state["fb"].items()}}
    pf, pi, sf, si, lanes, ring, v, pd, sd = kernel.operands(
        params, state, 2 * block, {})
    final = kernel.finish(sf, si, ring, v)
    return compiled, ring, final


@pytest.mark.parametrize("buffer", [True, False])
def test_ring_span_only_in_buffer_mode(buffer):
    _pack_and_finish(buffer)   # the plan built before the trace
    spans = _profile(lambda: _pack_and_finish(buffer))
    rings = [s for s in spans if s[0] == "srk.ring"]
    finishes = [s for s in spans if s[0] == "srk.finish"]
    assert len(finishes) == 1
    if not buffer:
        assert rings == []
        return
    assert len(rings) == 2
    assert {s[4] for s in rings} == {False}   # host ops, not annotations
    packed, unpacked = rings
    assert packed[2] <= finishes[0][1]
    assert finishes[0][1] <= unpacked[1] and unpacked[2] <= finishes[0][2]


def test_ring_span_needs_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    compiled, ring, final = _pack_and_finish(True, voices=2, block=32)
    assert tuple(ring.shape) == (len(compiled.fb_keys), 32, 2)
    assert set(final["fb"]) == set(compiled.fb_keys)
    assert all(tuple(a.shape) == (2, 32) for a in final["fb"].values())


@pytest.mark.parametrize("buffer, block, words", [
    (True, 1024, 2048), (True, 64, 128), (False, 1024, 0)])
def test_ring_words(buffer, block, words):
    compiled, kernel, _ = _kernel(buffer, block)
    assert kernel.ring_words == words
    assert kernel.ring_words == (len(compiled.fb_keys) * block if buffer
                                 else 0)
