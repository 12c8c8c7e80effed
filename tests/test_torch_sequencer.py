"""The torch port's Grid and Pattern sequencers against the JAX package.

* The per-sample steps, stepped together with the JAX steps (eagerly, so
  XLA has no ``a*b+c`` to contract) on random Step and Sync gates for 4
  voices: the gates cross the wrap, Sync resets the pointer, the tables
  hold slide cells and negative notes, one voice's ``n_steps`` lies past
  the table's capacity (so the lookup reads outside ``[0, K)`` and must
  give the JAX select tree's answer) and one voice's is 0.  Outputs exact,
  int32 and bool state bit-exact.
* ``table_lookup`` against the JAX select tree for every index in
  ``[-70, 70)`` and every capacity.
* ``sequencer_patch`` end to end, from the JAX ``farm_params`` of 4
  voices at 4,800 Hz carried across: the port's scan engine equals the
  JAX scan engine at n=256 and the JAX fused Pallas kernel in interpret
  mode at n=32 and n=23 (audio ``atol=1e-5``, int32 and bool state
  bit-exact, float state 1e-5), the JAX renders made by
  ``tests/torch_parity_worker.py``.
* ``farm_params(sequencer_patch, 8)`` equal to the JAX package's.
* The whole-block forms ``_grid_block`` and ``_pat_block`` (on CPU
  tensors: the log-doubling scans and one ``torch.gather``) against the
  JAX block forms over [4, 300] rows from random carried states, with
  Step runs, Sync resets, notes in [-30, 30) and ``n_steps`` below the
  capacity: outputs and state exact; and against the port's own steps.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import srack_tpu as st
from srack_tpu import presets as jpresets
from srack_tpu.ops import basic as jbasic

import srack_tpu_torch as stt
from srack_tpu_torch import interop
from srack_tpu_torch.ops import basic as tbasic
from srack_tpu_torch.modules import sequencer as tseq

from test_torch_modules import V, assert_states, f32, gate_seq, run_both
from test_torch_slice import (ATOL, ROOT, WORKER, _complete, _env, _tree,
                              assert_state_close)

CAP = 8


def _pulses(rng, n, p):
    """Sparse positive pulses (Sync edges) on a zero line."""
    return [np.where(rng.uniform(size=V) < p, f32(rng, 0.1, 1.0), 0.0)
            .astype(np.float32) for _ in range(n)]


def _state(rng, grid: bool):
    state = {"current_step": rng.integers(0, 5, V).astype(np.int32),
             "step_last": rng.integers(0, 2, V).astype(bool),
             "sync_last": rng.integers(0, 2, V).astype(bool)}
    if grid:
        state["last_cv"] = f32(rng, -1.0, 1.0)
    return state


# per-voice sequence lengths: within the capacity, at it, past it (the
# lookup reads indices >= K) and 0 (every step wraps to 0)
N_STEPS = np.int32([5, CAP, CAP + 3, 0])


@pytest.mark.parametrize("sync", [True, False])
def test_grid_step_matches_jax(sync):
    rng = np.random.default_rng(11 + sync)
    params = {
        "notes": rng.integers(-30, 30, (V, CAP)).astype(np.int32),
        "cells": rng.integers(0, 3, (V, CAP)).astype(np.int32),
        "n_steps": N_STEPS,
        "steps_per_octave": np.int32([12, 7, 24, 5]),
    }
    assert (params["notes"] < 0).any() and (params["cells"] == 1).any()
    n = 160
    steps = gate_seq(rng, n, max_run=6)
    syncs = _pulses(rng, n, 0.05)
    ins = [[steps[t], syncs[t] if sync else None] for t in range(n)]
    out = run_both("Grid Sequencer", ("gridseq", 2, CAP), params,
                   _state(rng, True), ins, derive=True)
    wrapped = past = False
    for (jo, js), (to, ts) in out:
        for w, g in zip(jo, to):
            np.testing.assert_array_equal(g, w)
        assert_states(js, ts)
        wrapped |= bool((ts["current_step"][:2] == 0).any())
        past |= bool((ts["current_step"] > CAP - 1).any())
    assert wrapped and past  # the walk wrapped and read past the table


@pytest.mark.parametrize("sync", [True, False])
def test_pattern_step_matches_jax(sync):
    rng = np.random.default_rng(21 + sync)
    cells = rng.integers(0, 3, (V, tseq.N_ROWS, CAP)).astype(np.int32)
    packed = tseq._pat_derive(stt.AudioConfig(), None,
                              {"cells": torch.from_numpy(cells)},
                              None)["packed_tbl"].numpy()
    want = np.zeros_like(packed)
    for r in range(tseq.N_ROWS):
        want = want + cells[:, r, :] * 4 ** r
    np.testing.assert_array_equal(packed, want.astype(np.int32))
    # the JAX step takes the derived table (its derive packs rows on the
    # last two axes, which the voice-major layout here does not give it)
    params = {"n_steps": N_STEPS, "packed_tbl": packed}
    n = 160
    steps = gate_seq(rng, n, max_run=6)
    syncs = _pulses(rng, n, 0.05)
    ins = [[steps[t], syncs[t] if sync else None] for t in range(n)]
    out = run_both("Pattern Sequencer", ("patseq", tseq.N_ROWS, CAP),
                   params, _state(rng, False), ins)
    for (jo, js), (to, ts) in out:
        assert len(to) == tseq.N_ROWS + 1
        for w, g in zip(jo, to):
            np.testing.assert_array_equal(g, w)
        assert_states(js, ts)


@pytest.mark.parametrize("k", [1, 3, 8, 16, 24, 64])
def test_table_lookup_matches_select_tree(k):
    rng = np.random.default_rng(k)
    table = rng.integers(-1000, 1000, k).astype(np.int32)
    idx = np.arange(-70, 70, dtype=np.int32)
    want = np.asarray(jbasic.table_lookup(jnp.asarray(table),
                                          jnp.asarray(idx)))
    got = tbasic.table_lookup(torch.from_numpy(table),
                              torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    inside = idx[(idx >= 0) & (idx < k)]
    np.testing.assert_array_equal(got[70:70 + k], table[inside])


def test_make_and_coerce_match_jax():
    seq = [(0, True), None, (-5, False), (7, True)]
    for kwargs in ({"sequence": seq}, {"sequence": seq, "n_steps": 12},
                   {"n_steps": 3, "capacity": 20}, {}):
        jst, jp = st.modules.CATALOG["Grid Sequencer"].make(
            st.AudioConfig(), **kwargs)
        tst, tp = stt.CATALOG["Grid Sequencer"].make(stt.AudioConfig(),
                                                     **kwargs)
        assert jst == tst
        for key, w in jp.items():
            np.testing.assert_array_equal(tp[key].numpy(), np.asarray(w))
            assert tp[key].numpy().dtype == np.asarray(w).dtype
    pattern = [[True, None, False], [None] * 9]
    for kwargs in ({"pattern": pattern}, {"pattern": pattern, "n_steps": 4},
                   {}):
        jst, jp = st.modules.CATALOG["Pattern Sequencer"].make(
            st.AudioConfig(), **kwargs)
        tst, tp = stt.CATALOG["Pattern Sequencer"].make(stt.AudioConfig(),
                                                        **kwargs)
        assert jst == tst
        for key, w in jp.items():
            np.testing.assert_array_equal(tp[key].numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# sequencer_patch end to end
# ---------------------------------------------------------------------------

NAME = "sequencer_patch"


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    proc = subprocess.run([sys.executable, str(WORKER), str(out), NAME,
                           "seq_block"],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("ref_run", ["scan256", "k1_32", "k1_23"])
def test_sequencer_patch_matches_jax(jax_ref, ref_run):
    cfg = stt.AudioConfig(sample_rate=4800, block_size=64, channels=1)
    compiled = stt.compile_patch(stt.presets.sequencer_patch(cfg))
    assert list(compiled.plan) == list(jax_ref[f"{NAME}/plan"])
    assert compiled.fused_eligible()
    mids = compiled.instances
    params = interop.params_from_numpy(
        _complete(_tree(jax_ref, f"{NAME}/params"), mids, state=False))
    state = interop.state_from_numpy(
        _complete(_tree(jax_ref, f"{NAME}/state"), mids, state=True))
    n = int(ref_run[4:]) if ref_run.startswith("scan") else \
        int(ref_run.split("_")[1])
    audio, final = compiled.render_scan(params, state, n, batched=True,
                                        nograd=ref_run.startswith("k1"))
    want = jax_ref[f"{NAME}/{ref_run}/audio"]
    assert tuple(audio.shape) == want.shape
    np.testing.assert_allclose(audio.numpy(), want, atol=ATOL, rtol=0)
    if ref_run == "scan256":
        assert np.abs(want).max() > 0.05  # the sequencer really plays
    want_final = _complete(_tree(jax_ref, f"{NAME}/{ref_run}/final"), mids,
                           state=True)
    assert_state_close(final, want_final, f"{NAME} {ref_run}")


def test_farm_params_equal_jax():
    want = jpresets.farm_params(
        jpresets.sequencer_patch(st.AudioConfig(sample_rate=48000,
                                                channels=1)), 8)
    got = stt.presets.farm_params(
        stt.presets.sequencer_patch(stt.AudioConfig(sample_rate=48000,
                                                    channels=1)), 8)
    assert set(got) == set(want)
    for mid in want:
        assert set(got[mid]) == set(want[mid])
        for key, leaf in want[mid].items():
            w = np.asarray(leaf)
            g = got[mid][key].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w, err_msg=f"{mid}.{key}")


# ---------------------------------------------------------------------------
# the whole-block forms
# ---------------------------------------------------------------------------

def _block_inputs(jax_ref, kind):
    tag = f"seq_block/{kind}"
    params = {k: torch.from_numpy(v) for k, v in
              _tree(jax_ref, f"{tag}/params").items()}
    state = {k: torch.from_numpy(v) for k, v in
             _tree(jax_ref, f"{tag}/state").items()}
    step = torch.from_numpy(jax_ref[f"{tag}/step"])
    sync = torch.from_numpy(jax_ref[f"{tag}/sync"])
    mdef = tseq.GRID_SEQUENCER if kind == "grid" else tseq.PATTERN_SEQUENCER
    statics = (("gridseq", 2, CAP) if kind == "grid"
               else ("patseq", tseq.N_ROWS, CAP))
    derived = {**params, **mdef.derive(stt.AudioConfig(), statics, params,
                                       (True, True))}
    return tag, mdef, statics, derived, state, step, sync


@pytest.mark.parametrize("kind", ["grid", "pat"])
def test_block_form_matches_jax(jax_ref, kind):
    tag, mdef, statics, params, state, step, sync = _block_inputs(jax_ref,
                                                                  kind)
    n = step.shape[1]
    final, outs = mdef.block(stt.AudioConfig(), statics, params, state,
                             (step, sync), None, n)
    want = jax_ref[f"{tag}/outs"]
    np.testing.assert_array_equal(torch.stack(outs, dim=1).numpy(), want)
    want_final = _tree(jax_ref, f"{tag}/final")
    assert set(final) == set(want_final)
    for k, w in want_final.items():
        assert final[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(final[k].numpy(), w, err_msg=k)
    # Sync reset and the wrap both happened inside the block
    assert (sync > 0).any() and (want[:, -1] == 1.0).any()


@pytest.mark.parametrize("kind", ["grid", "pat"])
def test_block_form_equals_the_step(jax_ref, kind):
    _, mdef, statics, params, state, step, sync = _block_inputs(jax_ref,
                                                                kind)
    n = step.shape[1]
    final, outs = mdef.block(stt.AudioConfig(), statics, params, state,
                             (step, sync), None, n)
    s, want = state, []
    for t in range(n):
        s, o = mdef.step(stt.AudioConfig(), statics, params, s,
                         (step[:, t], sync[:, t]))
        want.append(torch.stack(o, dim=1))
    assert torch.equal(torch.stack(outs, dim=1), torch.stack(want, dim=-1))
    for k in s:
        assert torch.equal(final[k], s[k]), k


@pytest.mark.parametrize("kind", ["grid", "pat"])
def test_block_form_of_an_empty_sequence_takes_the_steps_answer(kind):
    """``n_steps = 0``: the per-sample step wraps every step to 0; XLA's
    ``x mod 0`` is ``x``, so the JAX block form counts on, and torch's
    remainder by 0 raises.  The port's block form gives the step's 0."""
    rng = np.random.default_rng(3)
    v, n = 2, 64
    mdef = tseq.GRID_SEQUENCER if kind == "grid" else tseq.PATTERN_SEQUENCER
    statics = (("gridseq", 2, CAP) if kind == "grid"
               else ("patseq", tseq.N_ROWS, CAP))
    params = {"n_steps": torch.zeros(v, dtype=torch.int32)}
    if kind == "grid":
        params.update(notes=torch.from_numpy(rng.integers(-9, 9, (v, CAP))
                                             .astype(np.int32)),
                      cells=torch.full((v, CAP), 2, dtype=torch.int32),
                      steps_per_octave=torch.full((v,), 12,
                                                  dtype=torch.int32))
    else:
        params["cells"] = torch.full((v, tseq.N_ROWS, CAP), 2,
                                     dtype=torch.int32)
    params.update(mdef.derive(stt.AudioConfig(), statics, params,
                              (True, False)))
    state = {k: a.expand(v).clone()
             for k, a in mdef.init_state(stt.AudioConfig(), statics).items()}
    step = torch.from_numpy(np.tile([1.0, 1.0, -1.0, -1.0], (v, n // 4))
                            .astype(np.float32))
    final, outs = mdef.block(stt.AudioConfig(), statics, params, state,
                             (step, None), None, n)
    s = state
    for t in range(n):
        s, o = mdef.step(stt.AudioConfig(), statics, params, s,
                         (step[:, t], None))
        for w, g in zip(o, outs):
            assert torch.equal(g[:, t], w)
    assert not final["current_step"].any()
