"""The check that decides ``correct``, on the CPU at sizes a test run holds.

* The control (the plain reference computed in bfloat16 in the program's
  place) fails each cell's limit.
* With the timed path broken underneath, a run of each cell comes out not
  correct: an answer altered where the render produces it, one render of
  the window altered, and one voice that the reference does not see
  altered in a later render (by ``renders_differing``).
* A sound run of each cell comes out correct.
* The reference's worker processes have all ended when it returns, and
  when a worker fails.

    python3 -m pytest -q bench_torch/tests
"""

from __future__ import annotations

import os
import time

import pytest
import torch

from bench_torch import control
from bench_torch.core import check, harness
from bench_torch.core.patchdesc import PatchDesc, load_json
from bench_torch.rehearse import tiny

BENCH = harness.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 32 + 977
BATCHES = 2


def _cell(name):
    cell = next(w for w in BENCH["workloads"] if w["name"] == name)
    traffic, seconds = tiny(load_json("traffic", cell["traffic"]))
    return cell, traffic, seconds


def _run(name, seconds=None, **sizes):
    cell, traffic, short = _cell(name)
    traffic.update(sizes)
    return harness.run_cell(BENCH, name, SEED, seconds or short, False,
                            time.perf_counter(), device="cpu",
                            traffic=traffic, workers=2)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limit(name):
    cell, traffic, seconds = _cell(name)
    gaps = control.control_gaps(BENCH, name, SEED, traffic, workers=2)
    limit = check.limits_for(name)["audio_gap"]
    assert len(gaps) == traffic["param_batches"] * \
        traffic["check_voices_per_batch"]
    assert min(gaps) > limit, gaps


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line = _run(name)
    assert line["correct"], line["checks"]


def _wrap_render(monkeypatch, change):
    from srack_tpu_torch.compiler import CompiledPatch
    original = CompiledPatch.render
    calls = []

    def broken(self, n_samples, **kw):
        audio, probes, state = original(self, n_samples, **kw)
        calls.append(n_samples)
        return change(audio, probes, state, kw, len(calls))

    monkeypatch.setattr(CompiledPatch, "render", broken)


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered_is_not_correct(name, monkeypatch):
    def alter(audio, probes, state, kw, call):
        audio = audio.clone()
        audio[..., audio.shape[-1] // 2] += 1e-3
        return audio, probes, state
    _wrap_render(monkeypatch, alter)
    line = _run(name)
    assert not line["correct"], line["checks"]
    assert line["checks"]["audio_gap"]["value"] > \
        line["checks"]["audio_gap"]["limit"]


def _unchecked_voice(name):
    cell, traffic, _ = _cell(name)
    driver = harness.load_file("drivers", traffic["driver"])
    traffic.update(n=256, param_batches=BATCHES)
    _, picks = driver.draw(PatchDesc.load(cell["config"]), traffic, SEED)
    return min(set(range(traffic["voices"])) - set(picks[0]))


@pytest.mark.parametrize("voice", [None, "unchecked"])
@pytest.mark.parametrize("name", CELLS)
def test_one_render_altered_is_not_correct(name, voice, monkeypatch):
    """A later render of the first batch altered in one sample: of every
    voice, or of one voice that the reference does not see."""
    rows = slice(None) if voice is None else _unchecked_voice(name)

    def alter(audio, probes, state, kw, call):
        # call 1 is set-up's render; call 2 + BATCHES renders the first
        # batch a second time
        if call == 2 + BATCHES:
            audio = audio.clone()
            audio[rows, ..., 7] += 1e-3
        return audio, probes, state
    _wrap_render(monkeypatch, alter)
    line = _run(name, seconds=4.0, n=256, param_batches=BATCHES)
    assert line["attempted"] > BATCHES
    assert not line["correct"], line["checks"]
    assert line["checks"]["renders_differing"]["value"] > 0
    assert line["checks"]["audio_gap"]["value"] == 0.0


def test_stretch_sums_see_one_sample_and_a_shift():
    from bench_torch.drivers.render_batch import stretch_sums
    audio = torch.randn(3, 2, 6400)
    base = stretch_sums(audio)
    one = audio.clone()
    one[1, 1, 5000] = torch.nextafter(one[1, 1, 5000], torch.tensor(9.0))
    shifted = audio.clone()
    shifted[2] = torch.roll(audio[2], 1, -1)
    for changed, voice in ((one, 1), (shifted, 2)):
        differ = (stretch_sums(changed) != base).any(-1)
        assert differ.tolist() == [v == voice for v in range(3)]


def test_no_card_no_result(capsys, monkeypatch):
    from bench_torch import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def _children() -> list:
    """The live processes whose parent is this one."""
    kids = []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        if int(stat[1]) == os.getpid() and stat[0] != "Z":
            kids.append(int(pid))
    return kids


@pytest.mark.parametrize("fails", [False, True])
def test_reference_workers_all_end(fails):
    from bench_torch.drivers.render_batch import checked
    name = CELLS[0]
    cell, traffic, seconds = _cell(name)
    desc = PatchDesc.load(cell["config"])
    items = [check.Item(p, 64, None)
             for p, _ in checked(desc, traffic, SEED, seconds)]
    config = "no_such_config" if fails else cell["config"]
    before = set(_children())
    if fails:
        with pytest.raises(RuntimeError):
            check.reference_gaps(config, items, prec="bf16", workers=2)
    else:
        gaps = check.reference_gaps(config, items, prec="bf16", workers=2)
        assert len(gaps) == len(items) * traffic["check_voices_per_batch"]
    assert set(_children()) <= before
