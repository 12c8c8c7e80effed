"""The port's Freeverb module against the JAX package's, on the CPU.

From inputs made in ``tests/torch_parity_worker.py`` with numpy seeds (4
voices at 4,800 Hz: comb lines of 121-178 samples, allpasses of 24-63):

* ``_step`` over 256 samples from random rings with non-zero write
  indices and random filter states, against the JAX ``_step``: outputs and
  state within ``1e-6``;
* ``_block`` (on the CPU its plain version, the chunked form that is
  kernel K8's plain version) at n = 512 and n = 300 (a partial chunk) with
  automated ``room_size`` and ``wet`` lanes, against the JAX ``_block`` on
  its XLA path: within ``5e-6``;
* the same plain version against the JAX package's kernel K8 in interpret
  mode (``freeverb_kernel.entry`` at the shapes of
  ``tests/test_freeverb_kernel.py``: its lines, about those of 8 kHz,
  n = 256): within ``2e-5``, that test's tolerance.

Also: a render in pieces of any length equals the per-sample step, and
the module's state leaves cross between the packages through ``interop``.
The JAX references run in their own process with ``--xla_cpu_max_isa=AVX``
(see ``torch_parity_worker.py``).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import srack_tpu_torch as stt
from srack_tpu_torch import interop
from srack_tpu_torch.modules import freeverb as fv

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_parity_worker.py"
CFG = stt.AudioConfig(sample_rate=4800, channels=2)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run([sys.executable, str(WORKER), str(out),
                           "freeverb"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _sub(ref, prefix):
    return {k[len(prefix) + 1:]: torch.from_numpy(v.copy())
            for k, v in ref.items() if k.startswith(prefix + "/")}


def _assert_state(got, want, atol):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype == torch.int32:
            assert torch.equal(g, w), k
        else:
            torch.testing.assert_close(g, w, atol=atol, rtol=0, msg=k)


def test_step_matches_jax(jax_ref):
    params = _sub(jax_ref, "freeverb/params")
    state = _sub(jax_ref, "freeverb/state")
    lanes = torch.from_numpy(jax_ref["freeverb/step/lanes"])
    statics = ("freeverb",)
    # the step writes the rings in place: the engines hand it a copy
    s = {k: a.clone() for k, a in state.items()}
    outs = []
    for t in range(lanes.shape[-1]):
        s, o = fv.FREEVERB.step(CFG, statics, params, s,
                                [lanes[0, :, t], lanes[1, :, t]])
        outs.append(torch.stack(o, dim=1))
    audio = torch.stack(outs, dim=-1)
    torch.testing.assert_close(
        audio, torch.from_numpy(jax_ref["freeverb/step/audio"]), atol=1e-6,
        rtol=0)
    _assert_state(s, _sub(jax_ref, "freeverb/step/final"), 1e-6)
    # the caller's state was not touched
    for k, a in _sub(jax_ref, "freeverb/state").items():
        assert torch.equal(state[k], a)


@pytest.mark.parametrize("n", [512, 300])
def test_block_matches_jax_block(jax_ref, n):
    params = _sub(jax_ref, "freeverb/params")
    params.update(_sub(jax_ref, f"freeverb/block{n}/autos"))
    state = _sub(jax_ref, "freeverb/state")
    lanes = torch.from_numpy(jax_ref[f"freeverb/block{n}/lanes"])
    new_state, outs = fv.FREEVERB.block(CFG, ("freeverb",), params, state,
                                        [lanes[0], lanes[1]], None, n)
    torch.testing.assert_close(
        torch.stack(outs, dim=1),
        torch.from_numpy(jax_ref[f"freeverb/block{n}/audio"]), atol=5e-6,
        rtol=0)
    _assert_state(new_state, _sub(jax_ref, f"freeverb/block{n}/final"), 5e-6)


def test_block_plain_matches_jax_k8_interpret(jax_ref):
    """The plain version fed K8's raw form: the test's lines, the input
    already scaled (in_gain 1), the raw outputs (wet1 1, wet2 0, dry 0)."""
    mixed = torch.from_numpy(jax_ref["freeverb/k8/mixed"])[None]
    n = mixed.shape[-1]
    damp, feed = (torch.tensor([[x]]) for x in jax_ref[
        "freeverb/k8/damp_feed"])
    one, zero = torch.ones((1, 1)), torch.zeros((1, 1))
    state = {}
    for j, k in enumerate(fv.LINE_KEYS):
        state[k] = torch.from_numpy(jax_ref[f"freeverb/k8/hist{j}"])[None]
        state[f"{k}_idx"] = torch.zeros(1, dtype=torch.int32)
    for j, k in enumerate(fv.FS_KEYS):
        state[k] = torch.from_numpy(jax_ref["freeverb/k8/fs0"][j:j + 1])
    gains = (damp, feed, one, one, zero, zero)
    new_state, (out_l, out_r) = fv.block_plain(
        mixed, torch.zeros_like(mixed), gains, state, n)
    want = jax_ref["freeverb/k8/out"]
    np.testing.assert_allclose(out_l[0].numpy(), want[0], atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(out_r[0].numpy(), want[1], atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(
        np.stack([new_state[k][0].numpy() for k in fv.FS_KEYS]),
        jax_ref["freeverb/k8/fs"], atol=2e-5, rtol=2e-5)
    for j, k in enumerate(fv.LINE_KEYS):
        np.testing.assert_allclose(new_state[k][0].numpy(),
                                   jax_ref[f"freeverb/k8/final{j}"],
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("sizes", [[64] * 6 + [16], [33, 367], [400]])
def test_block_in_pieces_matches_the_step(sizes):
    """Renders whose lengths are no multiple of the chunk push no padding
    into the lines: the block form in pieces equals the per-sample step."""
    statics, params = fv.FREEVERB.make(CFG)
    n = sum(sizes)
    rng = np.random.default_rng(0)
    lr = torch.from_numpy((rng.standard_normal((2, n)) * 0.3)
                          .astype(np.float32))
    s = {k: a.clone() for k, a in fv.FREEVERB.init_state(CFG,
                                                         statics).items()}
    ref = []
    for t in range(n):
        s, o = fv.FREEVERB.step(CFG, statics, params, s, [lr[0, t], lr[1, t]])
        ref.append(torch.stack(o))
    ref = torch.stack(ref, dim=-1)
    batched = {k: a[None] for k, a in params.items()}
    s = {k: a[None] for k, a in fv.FREEVERB.init_state(CFG,
                                                       statics).items()}
    got, pos = [], 0
    for sz in sizes:
        s, o = fv.FREEVERB.block(CFG, statics, batched, s,
                                 [lr[None, 0, pos:pos + sz],
                                  lr[None, 1, pos:pos + sz]], None, sz)
        got.append(torch.stack(o, dim=1)[0])
        pos += sz
    torch.testing.assert_close(torch.cat(got, dim=-1), ref, atol=5e-6, rtol=0)


def test_state_crosses_packages_through_interop():
    statics, _ = fv.FREEVERB.make(CFG)
    state = {"states": {"m1": {k: a.expand((3,) + a.shape).contiguous()
                               for k, a in fv.FREEVERB.init_state(
                                   CFG, statics).items()}}, "fb": {}}
    back = interop.state_from_numpy(interop.to_numpy(state))
    for k, a in state["states"]["m1"].items():
        b = back["states"]["m1"][k]
        assert b.dtype == a.dtype and torch.equal(a, b), k
    assert back["states"]["m1"]["cl0"].shape == (
        3, fv.line_lengths(4800)[0][0])
    assert back["states"]["m1"]["cl0_idx"].dtype == torch.int32
