"""How a configuration reaches its plain reference, on the CPU.

* A configuration is checked by the reference file that its ``reference``
  key names, and a file of its own can route a module type that
  ``reference/modules.py`` lacks through the walk of ``reference/graph.py``.
* A configuration with no ``reference``, or one that names no file, fails
  when it is loaded, and the error gives the name.
* The rows that reach a module function declaring ``voices`` are the
  driver's picks, in order, after an uneven split over the workers; a run
  hands the check its picks too.
* The walk with its new keywords at their defaults renders today's
  configurations as before, bit for bit.

    python3 -m pytest -q bench_torch/tests
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import pytest

from bench_torch.core import check, harness
from bench_torch.core.patchdesc import PatchDesc, draw_farm_params, load_json
from bench_torch.drivers import render_batch
from bench_torch.reference import graph
from bench_torch.rehearse import tiny

BENCH = harness.load_bench()
CONFIGS = [c["name"] for c in BENCH["configs"]]
SEED = 2 ** 32 + 4099
TAG = 1000  # a voice's tag: its row plus TAG times its render's voices

# a reference file of the tests' own: the walk, plus a module type that
# modules.py lacks, whose output is its voice's tag
TOY_REFERENCE = '''
import numpy as np
import torch

from .graph import INPUTS, MODULES, render as walk


def row_tag(prec, params, ins, v, n, sr, voices):
    tag = voices["row"] + %d * voices["render_voices"]
    col = torch.from_numpy(tag.astype(np.float32)).reshape(v, 1)
    return {0: torch.broadcast_to(col, (v, n)).to(prec.dtype)}


def render(desc, params, n, prec, voices):
    return walk(desc, params, n, prec, voices,
                modules={**MODULES, "Row Tag": row_tag},
                inputs={**INPUTS, "Row Tag": ()})
''' % TAG


@pytest.fixture
def toy_config(temp_reference):
    """The name of a configuration of the tag that names a reference file
    of its own; both exist only while the test runs."""
    return temp_reference(_toy_config(None), TOY_REFERENCE)


def _toy_config(reference) -> dict:
    """A patch of the tag, through a known module type, to the Output."""
    spec = {"name": "row_tags",
            "audio": {"sample_rate": 48000, "block_size": 1024,
                      "channels": 1, "precision": "fast",
                      "buffer_feedback": False},
            "modules": [{"name": "tag", "type": "Row Tag"},
                        {"name": "gain", "type": "Multiply",
                         "params": {"constant": 1.0}}],
            "connections": [["tag", 0, "gain", "In1"],
                            ["gain", 0, "output", 0]]}
    if reference is not None:
        spec["reference"] = reference
    return spec


def _toy_traffic() -> dict:
    """Three batches of 3 checked voices of 6: 9 voices, an uneven split
    over 2 workers."""
    traffic = dict(load_json("traffic", "farm1k"))
    traffic.update(voices=6, n=64, param_batches=3, check_voices_per_batch=3)
    return traffic


def test_configuration_checked_by_its_reference(toy_config):
    desc = PatchDesc.load(toy_config)
    assert desc.reference == toy_config
    assert "Row Tag" not in graph.MODULES
    traffic = _toy_traffic()
    items = render_batch.checked_items(desc, traffic, SEED, 0.01)
    for it in items:
        tag = it.voices["row"] + TAG * it.voices["render_voices"]
        it.audio = np.broadcast_to(tag.astype(np.float32)[:, None, None],
                                   (len(tag), 1, it.n)).copy()
    assert check.reference_gaps(toy_config, items, workers=2) == [0.0] * 9
    items[1].audio[2, 0, 17] += 0.5
    gaps = check.reference_gaps(toy_config, items, workers=2)
    assert gaps == [0.0] * 5 + [0.5] + [0.0] * 3


@pytest.mark.parametrize("reference", [None, "no_such_reference",
                                       "../core/check", "graph.py"])
def test_unknown_reference_fails_at_load(reference):
    with pytest.raises(ValueError) as err:
        PatchDesc(_toy_config(reference))
    assert repr(reference) in str(err.value)
    assert "row_tags" in str(err.value)


@pytest.mark.parametrize("config", CONFIGS)
def test_todays_configurations_name_the_walk(config):
    assert PatchDesc.load(config).reference == "graph"


def test_rows_reach_the_module_in_order(toy_config):
    desc = PatchDesc.load(toy_config)
    traffic = _toy_traffic()
    _, picks = render_batch.draw(desc, traffic, SEED)
    items = render_batch.checked_items(desc, traffic, SEED, 0.01)
    for it in items:
        it.audio = np.zeros((3, 1, it.n), np.float32)
    gaps = check.reference_gaps(toy_config, items, workers=2)
    want = [float(j + TAG * traffic["voices"]) for js in picks for j in js]
    assert gaps == want
    assert len(gaps) % 2 == 1


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_run_hands_the_check_its_picks(name, monkeypatch):
    cell = next(w for w in BENCH["workloads"] if w["name"] == name)
    traffic, seconds = tiny(load_json("traffic", cell["traffic"]))
    traffic.update(n=256, param_batches=2)
    seen = []
    original = check.reference_gaps

    def spy(config, items, **kw):
        seen.extend(items)
        return original(config, items, **kw)

    monkeypatch.setattr(check, "reference_gaps", spy)
    line = harness.run_cell(BENCH, name, SEED, 1.0, False,
                            time.perf_counter(), device="cpu",
                            traffic=traffic, workers=2)
    assert line["correct"], line["checks"]
    _, picks = render_batch.draw(PatchDesc.load(cell["config"]), traffic,
                                 SEED)
    assert len(seen) == min(2, line["attempted"])
    for it, js in zip(seen, picks):
        assert it.voices["row"].tolist() == js
        assert it.voices["render_voices"].tolist() == \
            [traffic["voices"]] * len(js)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("config", CONFIGS)
def test_walk_defaults_render_as_before(config, prec):
    """4 voices x 4,096 samples (past the first gate edge): the call as it
    was, the new keywords given explicitly with rows, and the
    configuration's own reference agree bit for bit."""
    desc = PatchDesc.load(config)
    params = draw_farm_params(desc, 4, SEED)
    n = 4096
    rows = check.rows_in([5, 0, 1023, 7], 1024)
    before = graph.render(desc, params, n, prec)
    keywords = graph.render(desc, params, n, prec, rows,
                            modules=graph.MODULES, inputs=graph.INPUTS)
    named = importlib.import_module(
        f"bench_torch.reference.{desc.reference}").render(
            desc, params, n, prec, rows)
    assert before.shape == (4, desc.channels, n)
    assert np.abs(before).max() > 0
    for other in (keywords, named):
        assert np.array_equal(_bits(before), _bits(other))
