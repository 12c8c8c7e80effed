"""No process of a run may hold JAX or the JAX package, on the CPU.

* The names are compared whole: the port's package, whose name begins
  with the JAX package's, is no match.
* A run whose program loads JAX in the window, or which loads a module of
  the JAX package while it checks, prints no result, exits non-zero and
  names the module on standard error; the same run without it prints its
  line.
* A reference worker that loads flax hands back no gaps.

    python3 -m pytest -q bench_torch/tests
"""

from __future__ import annotations

import json
import sys
import time
import types

import pytest
import torch

from bench_torch import run
from bench_torch.core import check, harness
from bench_torch.core.patchdesc import PatchDesc, load_json
from bench_torch.drivers import render_batch
from bench_torch.rehearse import tiny

BENCH = harness.load_bench()
CELL = BENCH["workloads"][0]
SEED = 2 ** 32 + 8191

# the walk, from a file that loads flax as it is imported
FLAX_REFERENCE = '''
import sys
import types

from .graph import render  # noqa: F401

sys.modules.setdefault("flax", types.ModuleType("flax"))
'''


def test_names_are_compared_whole():
    assert check.foreign_modules(
        ["srack_tpu_torch", "srack_tpu_torch.ops.fused", "jaxtyping",
         "flaxen.x", "torch", "numpy"]) == []
    assert check.foreign_modules(
        ["jax.numpy", "srack_tpu.modules", "flax", "jaxlib.xla_client",
         "torch"]) == ["flax", "jax", "jaxlib", "srack_tpu"]


def _plant(name: str, monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))


@pytest.mark.parametrize("plant", [None, "window", "check"])
def test_a_run_holding_jax_prints_no_result(plant, capsys, monkeypatch):
    from srack_tpu_torch.compiler import CompiledPatch
    traffic, _ = tiny(load_json("traffic", CELL["traffic"]))
    cell_run = harness.run_cell

    def on_cpu(*args):
        return cell_run(*args, device="cpu", traffic=traffic, workers=2)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", on_cpu)
    if plant == "window":
        render = CompiledPatch.render

        def loads_jax(self, n_samples, **kw):
            _plant("jax", monkeypatch)
            return render(self, n_samples, **kw)

        monkeypatch.setattr(CompiledPatch, "render", loads_jax)
    elif plant == "check":
        gaps = check.reference_gaps

        def loads_the_jax_package(config, items, **kw):
            _plant("srack_tpu.modules", monkeypatch)
            return gaps(config, items, **kw)

        monkeypatch.setattr(check, "reference_gaps", loads_the_jax_package)
    rc = run.main(["--workload", CELL["name"], "--seed", str(SEED),
                   "--seconds", "0.01", "--trace", "0"])
    out, err = capsys.readouterr()
    if plant is None:
        assert rc == 0
        assert json.loads(out.splitlines()[-1])["correct"]
    else:
        assert rc != 0
        assert out == ""
        found = "jax" if plant == "window" else "srack_tpu"
        assert f"sys.modules holds {found}: no result" in err


def test_a_reference_worker_holding_flax_hands_back_nothing(
        temp_reference, capfd):
    name = temp_reference(load_json("configs", CELL["config"]),
                          FLAX_REFERENCE)
    traffic, seconds = tiny(load_json("traffic", CELL["traffic"]))
    traffic.update(n=64)
    items = render_batch.checked_items(PatchDesc.load(name), traffic, SEED,
                                       seconds)
    with pytest.raises(check.ForeignModules):
        check.reference_gaps(name, items, prec="bf16", workers=2)
    assert "reference worker: sys.modules holds flax" in capfd.readouterr().err
