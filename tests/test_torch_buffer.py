"""Buffer-feedback compat mode of the torch port against the JAX package.

``feedback_patch`` with ``buffer_feedback=True`` and block 32, from the JAX
``farm_params`` of 4 voices at 4,800 Hz carried across:

* the port's scan engine (its block loop, the counterpart of
  ``_render_buffer_mode``) equals the JAX scan engine at n=128;
* the port's scan engine with ``nograd`` (kernel K2's plain version)
  equals the JAX buffer-feedback Pallas kernel K2 in interpret mode at
  n=64;
* audio ``atol=1e-5``, int32 and bool state bit-exact, float state and the
  final ``fb`` leaves (``[V, block]``) within 1e-5.

The JAX renders come from ``tests/torch_parity_worker.py``.  Also: the
mode's block rule and the delayed feedback itself.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import srack_tpu_torch as stt
from srack_tpu_torch import interop

from test_torch_slice import (ATOL, ROOT, WORKER, _complete, _env, _tree,
                              assert_state_close)

NAME = "feedback_buffer"
BLOCK = 32


def _cfg(block=BLOCK):
    return stt.AudioConfig(sample_rate=4800, block_size=block, channels=1,
                           buffer_feedback=True)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    proc = subprocess.run([sys.executable, str(WORKER), str(out), NAME],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("ref_run", ["scan128", "k2_64"])
def test_buffer_mode_matches_jax(jax_ref, ref_run):
    compiled = stt.compile_patch(stt.presets.feedback_patch(_cfg()))
    assert list(compiled.plan) == list(jax_ref[f"{NAME}/plan"])
    assert compiled.fused_eligible() and compiled.fb_keys
    mids = compiled.instances
    params = interop.params_from_numpy(
        _complete(_tree(jax_ref, f"{NAME}/params"), mids, state=False))
    state = interop.state_from_numpy(
        _complete(_tree(jax_ref, f"{NAME}/state"), mids, state=True))
    assert all(tuple(f.shape) == (4, BLOCK) for f in state["fb"].values())
    n = int(ref_run[4:]) if ref_run.startswith("scan") else \
        int(ref_run.split("_")[1])
    audio, final = compiled.render_scan(params, state, n, batched=True,
                                        nograd=ref_run.startswith("k2"))
    want = jax_ref[f"{NAME}/{ref_run}/audio"]
    assert tuple(audio.shape) == want.shape
    np.testing.assert_allclose(audio.numpy(), want, atol=ATOL, rtol=0)
    assert np.abs(want).max() > 0.01
    want_final = _complete(_tree(jax_ref, f"{NAME}/{ref_run}/final"), mids,
                           state=True)
    assert set(want_final["fb"]) == set(compiled.fb_keys)
    assert_state_close(final, want_final, f"{NAME} {ref_run}")


def test_buffer_mode_renders_whole_blocks():
    patch = stt.presets.feedback_patch(_cfg())
    compiled = stt.compile_patch(patch)
    with pytest.raises(ValueError, match="multiple of block_size"):
        compiled.render(48, device="cpu")
    with pytest.raises(ValueError, match="multiple of block_size"):
        compiled.render(64, segment=16, device="cpu")
    state = compiled.init_state()
    assert all(tuple(f.shape) == (BLOCK,) for f in state["fb"].values())
    audio, _, final = compiled.render(64, device="cpu")
    assert tuple(audio.shape) == (1, 64)
    assert all(tuple(f.shape) == (BLOCK,) for f in final["fb"].values())


def test_feedback_reads_arrive_one_block_late():
    """A feedback wire carries its source's value from ``block`` samples
    earlier: in a chain where a VCA reads the mixer that it feeds, sample
    t of the mixer sees the oscillator through the loop at t - block."""
    def build(cfg):
        p = stt.Patch(cfg)
        osc = p.add("Oscillator", val=-2.0)
        mix = p.add("Mono Mixer", gains=(1.0, 0.5))
        vca = p.add("VCA", negative=True)
        one = p.add("Add", constant=1.0)
        p.connect(osc, "Sine", mix, 0)
        p.connect(vca, 0, mix, 1)        # feedback: vca runs after mix
        p.connect(mix, 0, vca, "Audio")
        p.connect(one, 0, vca, "CV")
        p.connect(mix, 0, p.output, 0)
        return p, osc

    block = 16
    p, osc = build(_cfg(block))
    compiled = stt.compile_patch(p)
    assert len(compiled.fb_keys) == 1
    audio, _, _ = compiled.render(64, device="cpu")
    q = stt.Patch(stt.AudioConfig(sample_rate=4800, channels=1))
    o = q.add("Oscillator", val=-2.0)
    q.connect(o, "Sine", q.output, 0)
    sine, _, _ = stt.render(q, 64, device="cpu")
    # mix[t] = sine[t] + 0.5 * mix[t - block] (0 before the first block)
    want = sine.clone()
    for t in range(block, 64):
        want[0, t] = sine[0, t] + 0.5 * want[0, t - block]
    torch.testing.assert_close(audio, want, atol=1e-6, rtol=0)
