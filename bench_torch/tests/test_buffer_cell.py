"""The cell ``buffer.farm1k`` (``feedback_patch`` on kernel K2), on the CPU.

* ``work/buffer.py``'s ring holds the words the program's K2 keeps a voice
  (``FusedKernel.ring_words``), and its operation counts are the
  program's; the bound at the cell's shape is 1.3146 ms, operations-bound.
* ``buffer_roofline_pct`` reads K2's time against that bound, and nothing
  from a trace without K2 or for a configuration outside buffer mode.
* The cell runs end to end at a tiny shape and comes out correct; with
  the timed path broken (an answer altered, one render altered) it comes
  out not correct.

    python3 -m pytest -q bench_torch/tests/test_buffer_cell.py
"""

from __future__ import annotations

import time

import pytest

from bench_torch.core import harness
from bench_torch.core.patchdesc import PatchDesc, load_json
from bench_torch.core.tracing import TraceData
from bench_torch.rehearse import tiny
from bench_torch.work import buffer, roofline

BENCH = harness.load_bench()
CELL = "buffer.farm1k"
SEED = 2 ** 32 + 6007
MS = 1_000_000


def _desc():
    return PatchDesc.load("feedback_patch")


def test_ring_words_are_the_programs():
    import srack_tpu_torch as stt
    from srack_tpu_torch.ops import fused
    desc = _desc()
    patch, _ = desc.build(stt)
    kernel = fused.FusedKernel(stt.compile_patch(patch))
    assert buffer.ring_words(desc) == kernel.ring_words == 2048


def test_operation_counts_are_the_programs():
    import srack_tpu_torch as stt
    from srack_tpu_torch.ops import partition
    desc = _desc()
    patch, ids = desc.build(stt)
    compiled = stt.compile_patch(patch)
    ours = {m["name"]: roofline.step_ops(desc, m) for m in desc.modules}
    theirs = {m["name"]: partition.module_ops(compiled, ids[m["name"]])
              for m in desc.modules}
    assert ours == theirs
    assert sum(ours.values()) == 175


def test_bound_at_the_cells_shape():
    traffic = load_json("traffic", "farm1k_blocks")
    v, n = traffic["voices"], traffic["n"]
    assert (v, n) == (1024, 491520) and n % _desc().block_size == 0
    nbytes, ops = buffer.buffer_work(_desc(), v, n)
    assert ops == 175 * v * n
    fused_bytes, _ = roofline.fused_work(_desc(), v, n)
    assert nbytes == fused_bytes + 2 * 4 * v * 2048
    ms, by = roofline.bound_ms(nbytes, ops)
    assert (round(ms, 3), by) == (1.315, "operations")
    assert round(ms, 4) == 1.3146


def _readers(device, desc=None, renders=2):
    data = TraceData(device, {}, [], (0, 1000 * MS))
    return harness.Readers(data, desc or _desc(),
                           {"renders": renders, "voices": 1024, "n": 491520})


def test_reader_share_of_k2():
    reader = harness.load_file("metrics", "buffer_roofline_pct")
    device = [(100 * MS, 172 * MS, "srk_fused_kernel"),
              (300 * MS, 372 * MS, "srk_fused_kernel"),
              (372 * MS, 373 * MS, "aten::copy_ kernel")]
    bound, _ = roofline.bound_ms(*buffer.buffer_work(_desc(), 1024, 491520))
    got = reader.read(_readers(device))
    assert got == pytest.approx(100 * bound * 2 / 144, rel=1e-12)
    assert 1.8 < got < 1.9


@pytest.mark.parametrize("case", ["no K2", "empty", "no renders",
                                  "sample mode"])
def test_reader_finds_nothing(case):
    reader = harness.load_file("metrics", "buffer_roofline_pct")
    device = [(0, 5 * MS, "aten::copy_ kernel")] if case == "no K2" else \
        [(0, 70 * MS, "srk_fused_kernel")]
    if case == "empty":
        device = []
    desc = PatchDesc.load("subtractive_voice") if case == "sample mode" \
        else None
    renders = 0 if case == "no renders" else 2
    assert reader.read(_readers(device, desc, renders)) is None


def _run(seconds=None, trace=False, **sizes):
    traffic, short = tiny(load_json("traffic", "farm1k_blocks"))
    traffic.update(sizes)
    return harness.run_cell(BENCH, CELL, SEED, seconds or short, trace,
                            time.perf_counter(), device="cpu",
                            traffic=traffic, workers=2)


def test_cell_runs_and_is_correct():
    line = _run()
    assert line["correct"], line["checks"]
    assert line["checks"]["audio_gap"]["value"] == 0.0
    assert set(line["metrics"]) == {"samples_per_s", "setup_s"}


def _wrap_render(monkeypatch, change):
    from srack_tpu_torch.compiler import CompiledPatch
    original = CompiledPatch.render
    calls = []

    def broken(self, n_samples, **kw):
        audio, probes, state = original(self, n_samples, **kw)
        calls.append(n_samples)
        return change(audio, len(calls)), probes, state

    monkeypatch.setattr(CompiledPatch, "render", broken)


def test_answer_altered_is_not_correct(monkeypatch):
    def alter(audio, call):
        audio = audio.clone()
        audio[..., 3000] += 1e-3
        return audio
    _wrap_render(monkeypatch, alter)
    line = _run()
    assert not line["correct"], line["checks"]
    assert line["checks"]["audio_gap"]["value"] > 1e-4


def test_one_render_altered_is_not_correct(monkeypatch):
    """A later render of the first batch altered in one sample, at the
    shortest length buffer mode renders: a block."""
    batches = 2

    def alter(audio, call):
        # call 1 is set-up's render; call 2 + batches renders the first
        # batch a second time
        if call == 2 + batches:
            audio = audio.clone()
            audio[..., 7] += 1e-3
        return audio
    _wrap_render(monkeypatch, alter)
    line = _run(seconds=4.0, n=1024, param_batches=batches)
    assert line["attempted"] > batches
    assert not line["correct"], line["checks"]
    assert line["checks"]["renders_differing"]["value"] > 0
    assert line["checks"]["audio_gap"]["value"] == 0.0


def test_run_hands_the_check_its_picks(monkeypatch):
    """The rows of the voices the check compares reach it with their
    params, at the shortest length buffer mode renders."""
    from bench_torch.core import check
    from bench_torch.drivers import render_batch
    traffic, _ = tiny(load_json("traffic", "farm1k_blocks"))
    traffic.update(n=1024, param_batches=2)
    seen = []
    original = check.reference_gaps

    def spy(config, items, **kw):
        seen.extend(items)
        return original(config, items, **kw)

    monkeypatch.setattr(check, "reference_gaps", spy)
    line = harness.run_cell(BENCH, CELL, SEED, 1.0, False,
                            time.perf_counter(), device="cpu",
                            traffic=traffic, workers=2)
    assert line["correct"], line["checks"]
    _, picks = render_batch.draw(_desc(), traffic, SEED)
    assert len(seen) == min(2, line["attempted"])
    for it, js in zip(seen, picks):
        assert it.voices["row"].tolist() == js
