"""The port's farm and sharded training on a mesh of 8 CPU slots, against
the JAX package's (the twin of ``tests/test_parallel.py``).

torch has no virtual devices, so a CPU mesh is 8 ``cpu`` slots
(``Mesh`` built directly or by ``make_mesh(devices=...)``); each slot
renders its block of voices through the port's batched path.

* The mesh is 2-D, (4, 2) or (2, 4), with the axis names ``dp``, ``vp``.
* ``render_farm`` of exact subtractive_voice (4,800 Hz, 16 x 256) equals
  JAX's ``render_farm`` on its 8-device mesh within 5e-6
  (``tests/torch_parity_worker.py``, case ``farm``) and the port's own
  ``render_batch`` bit for bit; the mixdown within 1e-4.
* The sharded training step runs and its loss falls; the sharded fast
  step equals the unsharded scan step (loss 1e-5, params 1e-4).
* ``render_many(mesh=)``: the longest-processing-time placement holds the
  JAX tests' expectations on the slot assignment, and the renders equal
  ``render_many`` without a mesh bit for bit.
* The Noise rule: a voice's lane depends only on the key, the module, its
  seed and its index in the whole batch, so drum_machine and a plain Noise
  patch sharded over 8 slots (or 2, or 4) equal the local batched render
  bit for bit.
"""

import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import srack_tpu_torch as stt
from srack_tpu_torch.compiler import tree_leaves
from srack_tpu_torch.engine import place_groups
from srack_tpu_torch.parallel import (Mesh, make_mesh, render_farm,
                                      shard_batch)
from srack_tpu_torch.utils.train import SoundMatcher, batched_train_step

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_parity_worker.py"
CFG = stt.AudioConfig(sample_rate=4800, block_size=64, channels=1,
                      precision="exact")
FAST = stt.AudioConfig(sample_rate=4800, block_size=64, channels=1,
                       precision="fast")
V, N = 16, 256


def cpu_mesh(n=8):
    return make_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_farm") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run([sys.executable, str(WORKER), str(out), "farm"],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def test_mesh_is_2d_over_8_slots():
    mesh = cpu_mesh()
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("dp", "vp")
    assert mesh.devices.shape in ((4, 2), (2, 4))
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    direct = Mesh(np.array(["cpu"] * 8).reshape(4, 2), ("dp", "vp"))
    assert direct.shape == {"dp": 4, "vp": 2}
    assert direct.local_slots() == list(range(8))
    with pytest.raises(ValueError, match="do not split evenly"):
        shard_batch({"x": torch.zeros(12)}, mesh)


def test_render_farm_sharded_matches_jax_and_local(jax_ref):
    patch = stt.presets.subtractive_voice(CFG)
    params = stt.presets.farm_params(patch, V)
    farm = render_farm(patch, N, params=params, mesh=cpu_mesh())
    audio = farm[0]
    assert farm.voices == range(V)
    assert tuple(jax_ref["farm/slots"]) in ((4, 2), (2, 4))
    np.testing.assert_allclose(audio.numpy(), jax_ref["farm/audio"],
                               atol=5e-6, rtol=0)
    local, _, _ = stt.render_batch(patch, N, params=params, device="cpu")
    torch.testing.assert_close(audio, local, atol=0, rtol=0)


def test_render_farm_mixdown():
    patch = stt.presets.subtractive_voice(CFG)
    mesh = cpu_mesh()
    params = stt.presets.farm_params(patch, V)
    mixed, _, _ = render_farm(patch, N, params=params, mesh=mesh,
                              mixdown=True)
    per_voice, _, _ = render_farm(patch, N, params=params, mesh=mesh)
    assert tuple(mixed.shape) == (1, N)
    np.testing.assert_allclose(mixed.numpy(), per_voice.numpy().sum(axis=0),
                               atol=1e-4, rtol=0)


def test_render_farm_mixdown_matches_jax(jax_ref):
    patch = stt.presets.subtractive_voice(CFG)
    params = stt.presets.farm_params(patch, V)
    mixed, _, _ = render_farm(patch, N, params=params, mesh=cpu_mesh(),
                              mixdown=True)
    np.testing.assert_allclose(mixed.numpy(), jax_ref["farm/mixed"],
                               atol=1e-4, rtol=0)


def _fresh(train):
    return {m: {k: t.detach().clone().requires_grad_(True)
                for k, t in pd.items()} for m, pd in train.items()}


def test_sharded_training_step_runs_and_reduces():
    patch = stt.presets.sine_patch(CFG)
    compiled = stt.compile_patch(patch)
    ts = SoundMatcher(patch, N, device="cpu").init()
    step = batched_train_step(
        compiled, functools.partial(torch.optim.Adam, lr=1e-2), N,
        mesh=cpu_mesh(), device="cpu")
    train, opt = ts["train"], None
    targets = torch.zeros(V, CFG.channels, N)
    losses = []
    for _ in range(3):
        train, opt, loss = step(train, ts["frozen"], opt, targets, 1)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] <= losses[0]


def test_sharded_fast_train_step_matches_scan_gradients():
    patch = stt.presets.subtractive_voice(FAST)
    compiled = stt.compile_patch(patch)
    ts = SoundMatcher(patch, N, device="cpu").init()
    sgd = functools.partial(torch.optim.SGD, lr=1e-2)
    targets = torch.full((V, FAST.channels, N), 0.1)
    fast = batched_train_step(compiled, sgd, N, fast=True, mesh=cpu_mesh(),
                              device="cpu")
    scan = batched_train_step(compiled, sgd, N, device="cpu")
    tf, _, lf = fast(_fresh(ts["train"]), ts["frozen"], None, targets, 1)
    tsc, _, ls = scan(_fresh(ts["train"]), ts["frozen"], None, targets, 1)
    assert abs(float(lf) - float(ls)) < 1e-5
    for a, b in zip(tree_leaves(tf), tree_leaves(tsc)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-4, rtol=0)


def test_render_many_mesh_places_groups_on_distinct_slots():
    patches = [stt.presets.sine_patch(FAST),
               stt.presets.subtractive_voice(FAST),
               stt.presets.sine_patch(FAST)]
    placed = place_groups(patches, 8)
    assert [idxs for idxs, _ in placed] == [[0, 2], [1]]
    assert len({slot for _, slot in placed}) == 2
    got = stt.render_many(patches, 128, key=3, mesh=cpu_mesh())
    want = stt.render_many(patches, 128, key=3, device="cpu")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_render_many_balances_load():
    """With more groups than slots the two heavy groups (subtractive x 3,
    sequencer x 3) land on different slots, as in the JAX test."""
    patches = [stt.presets.subtractive_voice(FAST) for _ in range(3)]
    patches += [stt.presets.sequencer_patch(FAST) for _ in range(3)]
    patches.append(stt.presets.sine_patch(FAST))
    extra = stt.Patch(FAST)
    o = extra.add("Oscillator", val=0.25)
    extra.connect(o, "Square", extra.output, 0)
    patches.append(extra)
    placed = place_groups(patches, 2)
    slot_of = {idxs[0]: slot for idxs, slot in placed}
    assert slot_of[0] != slot_of[3]
    mesh = Mesh(np.array(["cpu", "cpu"]), ("dp",))
    got = stt.render_many(patches, 64, key=1, mesh=mesh)
    want = stt.render_many(patches, 64, key=1, device="cpu")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def _noise_patch():
    p = stt.Patch(FAST)
    noise = p.add("Noise", seed=3, name="noise")
    p.connect(noise, 0, p.output, 0)
    return p


@pytest.mark.parametrize("name", ["drum_machine", "noise"])
def test_noise_rule_sharded_equals_local(name):
    patch = (_noise_patch() if name == "noise"
             else stt.presets.drum_machine(FAST))
    params = stt.presets.farm_params(patch, V)
    if name == "noise":  # two seeds, interleaved over the voices
        params[patch.module_ids[1]]["seed"] = torch.arange(V) % 2
    local, _, _ = stt.render_batch(patch, N, params=params, key=5,
                                   device="cpu")
    for slots in (8, 4, 2):
        farm, _, _ = render_farm(patch, N, params=params, key=5,
                                 mesh=cpu_mesh(slots))
        torch.testing.assert_close(farm, local, atol=0, rtol=0)


def test_noise_rows_follow_the_global_voice():
    """A shard of voices 8-15 drawn on its own gives the rows of voices
    8-15 of the whole batch, not those of voices 0-7."""
    patch = _noise_patch()
    compiled = stt.compile_patch(patch)
    params = stt.presets.farm_params(patch, V)
    whole = compiled._make_xs(params, 7, N, {})
    half = compiled._make_xs({m: {k: t[8:] for k, t in pd.items()}
                              for m, pd in params.items()}, 7, N, {},
                             voice0=8)
    (mid,) = whole
    torch.testing.assert_close(half[mid], whole[mid][8:], atol=0, rtol=0)
    assert not torch.equal(half[mid], whole[mid][:8])
