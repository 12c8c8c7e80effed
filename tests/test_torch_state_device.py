"""The initial state is made on the render's device.

``CompiledPatch.init_state(device)`` makes every leaf on ``device``
(each module's ``init_state`` takes the device), and the entry points
make a render's initial state on the device they render on and broadcast
it there with ``expand``: ``render``, ``render_stream``, ``migrate_state``,
``render_farm`` (each shard's render on its slot) and
``batched_train_step``.  Here, on the CPU:

* ``init_state("meta")`` puts every leaf on ``meta`` with the CPU build's
  shapes and dtypes: nothing of it is made on the host;
* ``init_state("cpu")`` equals the JAX package's ``init_state`` leaf for
  leaf (value, dtype, shape), in fast and exact precision and in buffer
  mode;
* each entry point asks ``init_state`` for its own device, and the state
  that reaches a batched render's engine is a broadcast (stride 0 on the
  voice axis) equal bit for bit to the host build expanded and made
  contiguous, as before.

The renders themselves are held to the JAX package by the parity tests
(``test_torch_render_api.py``: ``migrate_state``; ``test_torch_parallel.py``:
``render_farm``; ``test_torch_train.py``: ``batched_train_step``), and
here ``render_stream(voices=)``, whose state is now broadcast on its
device: audio and final state within ``1e-5`` of the JAX package's (the
fused-vs-scan tolerance of its tests).
"""

import functools

import numpy as np
import pytest
import torch

import srack_tpu as st
import srack_tpu_torch as stt
from srack_tpu_torch import compiler
from srack_tpu_torch.compiler import CompiledPatch, tree_leaves, tree_map
from srack_tpu_torch.parallel import make_mesh, render_farm
from srack_tpu_torch.utils.train import SoundMatcher, batched_train_step

SR = 4800
PRESETS = ("subtractive_voice", "reverb_patch", "sequencer_patch",
           "feedback_patch", "drum_machine", "sampler_kit")
CHECKS = ("block_check_patch", "kit_check_patch", "kernel_check_patch")
CASES = ([(name, prec, False) for name in PRESETS + CHECKS
          for prec in ("fast", "exact")]
         + [("feedback_patch", "fast", True)])


def _patches(name, prec, buffer):
    """The same patch built by both packages (the check patches through
    ``patch_cls``)."""
    kw = dict(sample_rate=SR, precision=prec, buffer_feedback=buffer,
              block_size=64)
    tcfg, jcfg = stt.AudioConfig(**kw), st.AudioConfig(**kw)
    if name in CHECKS:
        build = getattr(stt.presets, name)
        tp, jp = build(tcfg), build(jcfg, patch_cls=st.Patch)
    else:
        tp, jp = getattr(stt.presets, name)(tcfg), \
            getattr(st.presets, name)(jcfg)
    # block_check_patch returns (patch, automation)
    return (tp[0] if isinstance(tp, tuple) else tp,
            jp[0] if isinstance(jp, tuple) else jp)


def _flat(state: dict) -> dict:
    return {("states", mid, k): a for mid, sd in state["states"].items()
            for k, a in sd.items()} | {("fb", k): a
                                       for k, a in state["fb"].items()}


@pytest.mark.parametrize("name,prec,buffer", CASES)
def test_init_state_on_meta_makes_nothing_on_the_host(name, prec, buffer):
    compiled = stt.compile_patch(_patches(name, prec, buffer)[0])
    meta, cpu = _flat(compiled.init_state("meta")), \
        _flat(compiled.init_state("cpu"))
    assert meta.keys() == cpu.keys() and meta
    for key, a in meta.items():
        assert a.device.type == "meta", key
        assert a.shape == cpu[key].shape and a.dtype == cpu[key].dtype, key


@pytest.mark.parametrize("name,prec,buffer", CASES)
def test_init_state_on_cpu_equals_jax(name, prec, buffer):
    tp, jp = _patches(name, prec, buffer)
    got = _flat(stt.compile_patch(tp).init_state("cpu"))
    want = _flat(st.compile_patch(jp).init_state())
    assert got.keys() == want.keys()
    for key, w in want.items():
        g, w = got[key].numpy(), np.asarray(w)
        assert got[key].device.type == "cpu"
        assert g.shape == w.shape and g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w, err_msg=str(key))


@pytest.fixture
def asked(monkeypatch):
    """Every device ``CompiledPatch.init_state`` is asked for."""
    devices = []
    made = CompiledPatch.init_state

    def spy(self, device=None):
        devices.append(device)
        return made(self, device)
    monkeypatch.setattr(CompiledPatch, "init_state", spy)
    return devices


def test_render_broadcasts_the_state_it_made_on_its_device(asked,
                                                           monkeypatch):
    patch = stt.presets.reverb_patch(stt.AudioConfig(sample_rate=SR,
                                                     channels=2))
    compiled = stt.compile_patch(patch)
    v = 3
    seen = {}
    once = CompiledPatch._render_once

    def keep(self, n, params, state, *a, **kw):
        seen["state"] = state
        return once(self, n, params, state, *a, **kw)
    monkeypatch.setattr(CompiledPatch, "_render_once", keep)
    compiled.render(32, params=stt.presets.farm_params(patch, v),
                    batched=True, device="cpu")
    assert asked == [torch.device("cpu")]
    old = tree_map(lambda a: a.expand((v,) + a.shape).contiguous(),
                   compiled.init_state())
    got, want = _flat(seen["state"]), _flat(old)
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        assert g.device.type == "cpu" and g.dtype == w.dtype, key
        assert g.stride(0) == 0, key   # a broadcast, nothing copied
        assert torch.equal(g, w), key


def test_entry_points_ask_for_their_device(asked):
    cfg = stt.AudioConfig(sample_rate=SR, channels=1, block_size=64)
    patch = stt.presets.subtractive_voice(cfg)
    cpu = torch.device("cpu")
    next(stt.render_stream(patch, n_blocks=1, voices=2, device="cpu"))
    assert asked == [cpu]
    asked.clear()
    old = stt.compile_patch(patch)
    _, _, state = old.render(16, params=stt.presets.farm_params(patch, 2),
                             batched=True, device="cpu")
    asked.clear()
    patch.add("Oscillator", val=-2.0, name="new")
    new = stt.compile_patch(patch)
    migrated = compiler.migrate_state(old, new, state)
    # both layouts on meta, the new leaves on the live state's device
    assert asked == ["meta", "meta", cpu]
    for leaf in tree_leaves(migrated):
        assert leaf.device == cpu and leaf.shape[0] == 2
    asked.clear()
    render_farm(patch, 16, params=stt.presets.farm_params(patch, 4),
                mesh=make_mesh(devices=["cpu"] * 2))
    assert asked == [cpu, cpu]     # one a shard, on its slot
    asked.clear()
    voice = stt.presets.subtractive_voice(cfg)
    ts = SoundMatcher(voice, 16, device="cpu").init()
    step = batched_train_step(stt.compile_patch(voice), functools.partial(
        torch.optim.Adam, lr=1e-3), 16, fast=True, device="cpu")
    asked.clear()
    step(ts["train"], ts["frozen"], None, torch.zeros(2, 1, 16), 0)
    assert cpu in asked and all(d == cpu for d in asked)



def test_stream_of_voices_matches_jax():
    kw = dict(sample_rate=SR, block_size=16, channels=1)
    tp = stt.presets.sequencer_patch(stt.AudioConfig(**kw))
    jp = st.presets.sequencer_patch(st.AudioConfig(**kw))
    got = list(stt.render_stream(tp, n_blocks=6, voices=3, device="cpu"))
    want = list(st.render_stream(jp, n_blocks=6, voices=3))
    audio = np.concatenate([a.numpy() for a, _, _ in got], axis=-1)
    np.testing.assert_allclose(
        audio, np.concatenate([np.asarray(a) for a, _, _ in want], axis=-1),
        atol=1e-5, rtol=0)
    assert np.abs(audio).max() > 0.1
    g, w = _flat(got[-1][2]), _flat(want[-1][2])
    assert g.keys() == w.keys()
    for key, leaf in w.items():
        np.testing.assert_allclose(g[key].numpy(), np.asarray(leaf),
                                   atol=1e-5, rtol=0, err_msg=str(key))
