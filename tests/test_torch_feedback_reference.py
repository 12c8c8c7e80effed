"""The benchmark's plain reference of ``feedback_patch``
(``bench_torch/reference/feedback.py``: s-rack's engine a block at a time)
against the port, on the CPU.

* The configuration file builds the preset: the same modules in the same
  order, statics, params and wiring.
* The reference's cycle break deletes the edges the port's planner deletes
  and orders the modules as it does; the wires it reads a block late are
  the compiled plan's feedback keys.
* The port's render (``render_batch`` in buffer mode, the scan engine)
  equals the reference sample for sample on seeded ``farm_params``.
* A reference whose feedback comes one sample later, or one block later,
  than s-rack's fails the comparison, and so does the reference in
  bfloat16, by more than the cell's limit of 1e-4.
* The reference imports neither the port nor JAX nor the JAX package.
"""

import ast
import pathlib
import sys

import numpy as np
import pytest

import srack_tpu_torch as stt
from srack_tpu_torch.planner import plan_execution

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch.core.patchdesc import (PatchDesc, draw_farm_params,  # noqa: E402
                                        program_params)
from bench_torch.reference import feedback  # noqa: E402

LIMIT = 1e-4   # the cell's audio_gap limit
SEED = 2 ** 33 + 17


@pytest.fixture(scope="module")
def desc():
    return PatchDesc.load("feedback_patch")


@pytest.fixture(scope="module")
def built(desc):
    patch, ids = desc.build(stt)
    return patch, ids, {mid: name for name, mid in ids.items()}


def _program(desc, built, voices, n):
    patch, ids, _ = built
    params = draw_farm_params(desc, voices, SEED + n)
    audio, _, _ = stt.render_batch(
        patch, n, params=program_params(params, ids, patch, "cpu"),
        device="cpu")
    return params, audio.numpy()


@pytest.fixture(scope="module")
def rendered(desc, built):
    """The port's render of 6 voices x 3,072 samples (3 blocks)."""
    return _program(desc, built, 6, 3072)


def test_configuration_builds_the_preset(desc, built):
    patch, _, _ = built
    preset = stt.presets.feedback_patch(stt.AudioConfig(
        **{**desc.audio}))
    assert patch.config == preset.config
    ours, theirs = list(patch), list(preset)
    assert [(i.id, i.name, i.mdef.type_name, i.statics, i.inputs)
            for i in ours] == [(i.id, i.name, i.mdef.type_name, i.statics,
                                i.inputs) for i in theirs]
    a, b = patch.params(), preset.params()
    assert {m: {k: t.tolist() for k, t in pd.items()} for m, pd in a.items()} \
        == {m: {k: t.tolist() for k, t in pd.items()} for m, pd in b.items()}


def test_mixer_takes_its_params_name():
    p = stt.Patch(stt.AudioConfig(channels=1))
    by_param = p.add("Mono Mixer", gain=[0.5, 0.25, 0.0, 1.0])
    by_kwarg = p.add("Mono Mixer", gains=(0.5, 0.25, 0.0, 1.0))
    params = p.params()
    assert params[by_param.id]["gain"].tolist() == \
        params[by_kwarg.id]["gain"].tolist() == [0.5, 0.25, 0.0, 1.0]
    assert p[by_param.id].statics == p[by_kwarg.id].statics


@pytest.mark.parametrize("use_native", [True, False])
def test_cycle_break_is_the_planners(desc, built, use_native):
    patch, ids, names = built
    plan, broken = plan_execution(patch, use_native=use_native)
    ref_plan, ref_broken = feedback.cycle_break(desc)
    assert ref_plan == [names[m] for m in plan]
    # the planner's pairs are (sink, source), the reference's (source, sink)
    assert ref_broken == {(names[s], names[k]) for k, s in broken}
    assert ref_broken == {tuple(e) for e in desc.spec["broken_edges"]["edges"]}


def test_late_wires_are_the_ring(desc, built):
    patch, _, names = built
    compiled = stt.compile_patch(patch)
    assert feedback.late_wires(desc) == sorted(
        (names[m], port) for m, port in compiled.fb_keys)


@pytest.mark.parametrize("voices, n", [(4, 2048), (6, 3072)])
def test_program_equals_reference(desc, built, rendered, voices, n):
    params, audio = (rendered if (voices, n) == (6, 3072)
                     else _program(desc, built, voices, n))
    ref = feedback.render(desc, params, n, "f32")
    assert ref.shape == audio.shape == (voices, 1, n)
    assert np.abs(ref).max() > 0.05
    assert np.array_equal(ref.view(np.uint32), audio.view(np.uint32))


@pytest.mark.parametrize("lag", [1025, 2048])
def test_later_feedback_fails(desc, rendered, lag):
    """Feedback a sample later (1,025) or a block later (2,048) than
    s-rack's one block."""
    params, audio = rendered
    wrong = feedback.render(desc, params, 3072, "f32", lag=lag)
    assert np.abs(wrong - audio).max() > LIMIT


def test_bf16_fails(desc, rendered):
    params, audio = rendered
    control = feedback.render(desc, params, 3072, "bf16")
    assert np.abs(control - audio).max() > LIMIT


@pytest.mark.parametrize("n, lag", [(3000, None), (2048, 1000)])
def test_whole_blocks_and_lag(desc, rendered, n, lag):
    params, _ = rendered
    with pytest.raises(ValueError, match="whole blocks"):
        feedback.render(desc, params, n, "f32", lag=lag)


def test_reference_imports_no_program():
    tree = ast.parse((ROOT / "bench_torch" / "reference" / "feedback.py")
                     .read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.level == 0]
    assert names and not [n for n in names if n.split(".")[0] in
                          ("jax", "jaxlib", "srack_tpu", "srack_tpu_torch")]
