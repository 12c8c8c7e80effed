"""The torch port's Sample player against the JAX package, on the CPU.

* ``_step`` against the JAX ``_step`` over 512 samples, 4 voices at 4,800
  Hz: gate edges, the end crossing, retriggers, a voice of length 0, a
  carried state, rates 1, 0.5, 2 and 1 times 2^cv for integer CVs.  Exact.
* ``_block`` (on CPU tensors: K7's plain version, the unfused form on the
  log-doubling scans and one ``torch.gather``) against the JAX ``_block``
  (its unfused XLA form off the TPU), CV connected and not, n = 512 and
  300.  Outputs and state exact.
* The same plain form against JAX's K7 in interpret mode
  (``sample_kernel.play_rows``) at the shapes of the unmarked tests of
  ``tests/test_sample_kernel.py`` (K = 400 and 5,000; n = 4,608 and 4,196;
  scattered triggers): exact at representable rates; at base 0.937 with
  CVs in [-0.1, 0.1) JAX's own rule (``test_fuzz_irrational_rates``): at
  most 1e-3 of the samples differ (a one-ulp position can pick the
  neighbouring frame) and the end position agrees within rtol 1e-5.
* Continuity (two halves equal one render), the block form against the
  step, and ``make`` against the JAX ``make``.

The JAX results come from ``tests/torch_parity_worker.py`` (its own
process, ``--xla_cpu_max_isa=AVX``).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import srack_tpu as st

import srack_tpu_torch as stt
from srack_tpu_torch.modules import sample as smp

from test_torch_block_engine import _tree
from test_torch_slice import ROOT, WORKER, _env

CFG = stt.AudioConfig(sample_rate=4800)
STATICS = ("sample", 300)
K7_RUNS = ("k400_const1", "k400_const2", "k400_cv", "k400_fuzz",
           "k5000_const1", "k5000_cv")


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    proc = subprocess.run([sys.executable, str(WORKER), str(out), "sample"],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _state_equal(got: dict, want: dict, where: str) -> None:
    assert set(got) == set(want), where
    for k, w in want.items():
        assert got[k].dtype == w.dtype, (where, k)
        assert torch.equal(got[k], w), (where, k, got[k], w)


def test_step_matches_jax(jax_ref):
    params = _tree(jax_ref, "sample/step/params")
    state = _tree(jax_ref, "sample/step/state")
    gate = torch.from_numpy(jax_ref["sample/step/gate"])
    cv = torch.from_numpy(jax_ref["sample/step/cv"])
    outs = []
    s = state
    for t in range(gate.shape[1]):
        s, (o,) = smp.SAMPLE.step(CFG, STATICS, params, s,
                                  [gate[:, t], cv[:, t]])
        outs.append(o)
    got = torch.stack(outs, dim=1)
    want = jax_ref["sample/step/out"]
    np.testing.assert_array_equal(got.numpy(), want)
    _state_equal(s, _tree(jax_ref, "sample/step/final"), "step")
    # the case covers what it says: retriggers, an end crossing, silence
    assert (want[2] == 0).all() and (want[0] != 0).any()
    assert int(jax_ref["sample/step/params/length"][1]) < 300


@pytest.mark.parametrize("cv", [False, True])
@pytest.mark.parametrize("n", [512, 300])
def test_block_matches_jax(jax_ref, n, cv):
    tag = f"sample/block{n}_{'cv' if cv else 'const'}"
    params = _tree(jax_ref, f"{tag}/params")
    state = _tree(jax_ref, f"{tag}/state")
    gate = torch.from_numpy(jax_ref[f"{tag}/gate"])
    cvl = torch.from_numpy(jax_ref[f"{tag}/cv"]) if cv else None
    final, (out,) = smp.SAMPLE.block(CFG, STATICS, params, state,
                                     (gate, cvl), None, n)
    np.testing.assert_array_equal(out.numpy(), jax_ref[f"{tag}/out"])
    _state_equal(final, _tree(jax_ref, f"{tag}/final"), tag)


def _k7_inputs(jax_ref, tag):
    ins = _tree(jax_ref, f"sample/k7_{tag}/in")
    return (ins["gate"], ins.get("cv"), ins["table"], ins["base"],
            ins["pos"], ins["playing"], ins["last"], ins["length"])


@pytest.mark.parametrize("tag", K7_RUNS)
def test_plain_matches_jax_k7_interpret(jax_ref, tag):
    args = _k7_inputs(jax_ref, tag)
    out, pos_end, playing_end, gate_last = smp.play_unfused(*args)
    want = _tree(jax_ref, f"sample/k7_{tag}/out")
    assert (want["0"] != 0).any()  # the voices play
    if tag.endswith("fuzz"):
        mismatch = int((out != want["0"]).sum())
        assert mismatch <= out.numel() * 1e-3, mismatch
        torch.testing.assert_close(pos_end, want["1"], rtol=1e-5, atol=0)
    else:
        assert torch.equal(out, want["0"])
        assert torch.equal(pos_end, want["1"])
    assert torch.equal(playing_end, want["2"])
    assert torch.equal(gate_last, want["3"])


@pytest.mark.parametrize("cv", [False, True])
def test_block_halves_equal_one_render(cv):
    rng = np.random.default_rng(5)
    v, n, k = 3, 2300, 700
    params = {"samples": torch.from_numpy(rng.standard_normal((v, k)).astype(
                  np.float32)),
              "length": torch.tensor([k, 500, 90], dtype=torch.int32),
              "wav_sr": torch.tensor([4800.0, 2400.0, 9600.0])}
    gate = torch.from_numpy((rng.uniform(size=(v, n)) < 0.004).astype(
        np.float32))
    cvl = (torch.from_numpy(rng.integers(-1, 2, (v, n)).astype(np.float32))
           if cv else None)
    state = tree0 = {"pos": torch.zeros(v),
                     "playing": torch.zeros(v, dtype=bool),
                     "gate_last": torch.ones(v, dtype=bool)}
    statics = ("sample", k)
    whole_s, (whole,) = smp.SAMPLE.block(CFG, statics, params, tree0,
                                         (gate, cvl), None, n)
    h = 1100
    s1, (a,) = smp.SAMPLE.block(CFG, statics, params, state,
                                (gate[:, :h], None if cvl is None
                                 else cvl[:, :h]), None, h)
    s2, (b,) = smp.SAMPLE.block(CFG, statics, params, s1,
                                (gate[:, h:], None if cvl is None
                                 else cvl[:, h:]), None, n - h)
    assert torch.equal(torch.cat([a, b], dim=1), whole)
    _state_equal(s2, whole_s, "halves")
    # against the step, sample by sample (representable rates: exact)
    s, outs = tree0, []
    for t in range(n):
        s, (o,) = smp.SAMPLE.step(CFG, statics, params, s,
                                  [gate[:, t], None if cvl is None
                                   else cvl[:, t]])
        outs.append(o)
    assert torch.equal(torch.stack(outs, dim=1), whole)
    _state_equal(s, whole_s, "step")
    assert (whole != 0).any()


def test_make_matches_jax_and_patch_takes_numpy():
    wave = np.sin(np.arange(500) * 0.1).astype(np.float32)
    for kwargs in ({"samples": wave, "wav_sample_rate": 22050},
                   {"samples": wave, "max_len": 640},
                   {}):
        jst, jp = st.modules.CATALOG["Sample"].make(st.AudioConfig(),
                                                    **kwargs)
        tst, tp = stt.CATALOG["Sample"].make(stt.AudioConfig(), **kwargs)
        assert jst == tst
        for key, w in jp.items():
            assert tp[key].numpy().dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(tp[key].numpy(), np.asarray(w))
    p = stt.Patch(stt.AudioConfig(channels=1))
    h = p.add("Sample", samples=wave, wav_sample_rate=48000)
    assert p[h].params["samples"].shape == (500,)
    with pytest.raises(ValueError, match="max_len"):
        p.add("Sample", samples=wave, max_len=10)
