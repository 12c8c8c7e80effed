"""Hoisted lanes of the torch port against the JAX package: Input drivers,
Noise, automation and probes.

* ``lane_check_patch`` (a driven Input and an undriven one, Noise fed the
  same numpy lane as a driver in both packages, a Grid and a Pattern
  sequencer, automation arrays on an Oscillator's ``val`` and an ADSR's
  ``d_sec``, and an automated filter ``freq`` that holds its static value),
  from the JAX ``farm_params`` of 4 voices at 4,800 Hz carried across: the
  port's scan engine equals the JAX scan engine at n=256, its probes
  included, and the JAX fused Pallas kernel in interpret mode at n=32 and
  n=23 (audio ``atol=1e-5``, int32 and bool state bit-exact, float state
  1e-5).  The JAX renders come from ``tests/torch_parity_worker.py``.
* The automation rules of ``tests/test_automation.py`` in the port: a
  constant lane is bit-identical to the static param, and automating an
  Oscillator's ``val`` equals driving its CV from an Input.
* The port's own Noise draws: mean, variance and range of
  ``(u - 0.5) * 2`` over 2^20 draws, and determinism (same key, same
  audio; other keys, seeds or voices, other lanes).
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

NAME = "lane_check_patch"
CFG = stt.AudioConfig(sample_rate=4800, block_size=64, channels=2)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    proc = subprocess.run([sys.executable, str(WORKER), str(out), NAME],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _setup(jax_ref, probes=()):
    patch, autos = stt.presets.lane_check_patch(CFG)
    compiled = stt.compile_patch(patch, probes=probes, automation=autos)
    mids = compiled.instances
    params = interop.params_from_numpy(
        _complete(_tree(jax_ref, f"{NAME}/params"), mids, state=False))
    state = interop.state_from_numpy(
        _complete(_tree(jax_ref, f"{NAME}/state"), mids, state=True))
    drivers = {k[len(NAME) + 9:]: torch.from_numpy(a)
               for k, a in jax_ref.items()
               if k.startswith(f"{NAME}/drivers/")}
    return patch, compiled, params, state, drivers


@pytest.mark.parametrize("ref_run", ["scan256", "k1_32", "k1_23"])
def test_lane_check_patch_matches_jax(jax_ref, ref_run):
    patch, _, _, _, _ = _setup(jax_ref)
    ids = {inst.name: inst.id for inst in patch}
    probes = [(ids[m], p) for m, p in (("grid", 0), ("grid", 1), ("pat", 0),
                                       ("pat", 8), ("noise", 0),
                                       ("offset", 0), ("env", 0))]
    scan = ref_run.startswith("scan")
    patch, compiled, params, state, drivers = _setup(
        jax_ref, probes if scan else ())
    assert list(compiled.plan) == list(jax_ref[f"{NAME}/plan"])
    assert compiled.fused_eligible() != scan  # probes make it ineligible
    n = int(ref_run[4:]) if scan else int(ref_run.split("_")[1])
    # the Noise module's lane and the gate Input's come in as drivers; the
    # offset Input has none and emits its param
    assert set(drivers) == {ids["gate"], ids["noise"], f"{ids['vco']}~val",
                            f"{ids['env']}~d_sec"}
    xs = compiled._make_xs(params, 0, n,
                           {k: a[:, :n] for k, a in drivers.items()})
    assert set(xs) == set(drivers)
    audio, probe_vals, final = compiled._run(params, state, xs, n,
                                             batched=True, nograd=not scan)
    want = jax_ref[f"{NAME}/{ref_run}/audio"]
    assert tuple(audio.shape) == want.shape
    np.testing.assert_allclose(audio.numpy(), want, atol=ATOL, rtol=0)
    assert np.abs(want[:, 0]).max() > 0.05
    want_final = _complete(_tree(jax_ref, f"{NAME}/{ref_run}/final"),
                           compiled.instances, state=True)
    assert_state_close(final, want_final, f"{NAME} {ref_run}")
    if scan:
        want_probes = _tree(jax_ref, f"{NAME}/{ref_run}/probes")
        assert set(probe_vals) == set(want_probes) and len(want_probes) == 7
        for key, w in want_probes.items():
            np.testing.assert_allclose(probe_vals[key].numpy(), w,
                                       atol=ATOL, rtol=0, err_msg=key)
        # the undriven Input emits its constant, the driven Noise its lane
        np.testing.assert_array_equal(
            probe_vals[f"{ids['offset']}:0"].numpy(),
            np.broadcast_to(params[ids["offset"]]["value"].numpy()[:, None],
                            (4, n)))
        np.testing.assert_array_equal(probe_vals[f"{ids['noise']}:0"],
                                      drivers[ids["noise"]])


def _voice(val=0.0):
    p = stt.Patch(stt.AudioConfig(sample_rate=8000, channels=1))
    osc = p.add("Oscillator", val=val, name="vco")
    flt = p.add("Moog Filter", freq=0.4, res=0.3, name="vcf")
    env = p.add("ADSR", a_sec=0.01, d_sec=0.02, s_val=0.5, r_sec=0.02)
    vca = p.add("VCA")
    clk = p.add("Oscillator", val=-4.0, name="clock", antialiasing=False)
    p.connect(osc, "Sawtooth", flt, "Audio")
    p.connect(clk, "Square", env, "Gate")
    p.connect(flt, 0, vca, "Audio")
    p.connect(env, 0, vca, "CV")
    p.connect(vca, 0, p.output, 0)
    return p, osc, flt, env


@pytest.mark.parametrize("target", ["vco.val", "vcf.freq", "env.d_sec"])
def test_constant_lane_matches_static(target):
    n = 512
    p, osc, flt, env = _voice(val=-1.0)
    module, pname = {"vco.val": (osc, "val"), "vcf.freq": (flt, "freq"),
                     "env.d_sec": (env, "d_sec")}[target]
    ref, _, _ = stt.render(p, n, device="cpu")
    value = float(p[module].params[pname])
    lane = torch.full((n,), value, dtype=torch.float32)
    got, _, _ = stt.render(p, n, automation={(module, pname): lane},
                           device="cpu")
    assert float(ref.abs().max()) > 0.01
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


def test_val_automation_equals_cv_drive():
    n = 512
    rng = np.random.default_rng(0)
    lane = torch.from_numpy(rng.uniform(-1.5, 0.5, n).astype(np.float32))
    p, osc, _, _ = _voice(val=0.0)
    got, _, _ = stt.render(p, n, automation={(osc, "val"): lane},
                           device="cpu")
    q, osc2, _, _ = _voice(val=0.0)
    drv = q.add("Input", name="pitch")
    q.connect(drv, 0, osc2, "CV")
    want, _, _ = stt.render(q, n, drivers={drv: lane}, device="cpu")
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_automation_declares_scalar_float_params_only():
    p, osc, _, _ = _voice()
    with pytest.raises(KeyError, match="not declared"):
        stt.compile_patch(p).render(
            8, automation={(osc, "val"): np.zeros(8, np.float32)},
            device="cpu")
    q = stt.Patch(stt.AudioConfig(channels=1))
    grid = q.add("Grid Sequencer", sequence=[(0, True)])
    with pytest.raises(ValueError, match="float32"):
        stt.compile_patch(q, automation=[(grid, "n_steps")])
    with pytest.raises(KeyError, match="no param"):
        stt.compile_patch(p, automation=[(osc, "nope")])


def _noise_patch(seed=0):
    p = stt.Patch(stt.AudioConfig(sample_rate=4800, channels=1))
    noise = p.add("Noise", seed=seed, name="noise")
    p.connect(noise, 0, p.output, 0)
    return p


def test_noise_distribution():
    n, v = 1 << 17, 8  # 2^20 draws
    patch = _noise_patch(seed=5)
    params = stt.presets.farm_params(patch, v)
    audio, _, _ = stt.render_batch(patch, n, params=params, key=3,
                                   device="cpu")
    x = audio.double()
    assert audio.dtype == torch.float32 and tuple(audio.shape) == (v, 1, n)
    assert float(x.min()) >= -1.0 and float(x.max()) < 1.0
    # U[-1, 1): mean 0, variance 1/3; 5 sigma of 2^20 draws
    sigma_mean = (1 / 3) ** 0.5 / 2 ** 10
    assert abs(float(x.mean())) < 5 * sigma_mean
    assert abs(float(x.var()) - 1 / 3) < 5 * (4 / 45) ** 0.5 / 2 ** 10
    # each tenth of the range holds a tenth of the draws
    hist = torch.histc(x, bins=10, min=-1.0, max=1.0) / x.numel()
    assert float((hist - 0.1).abs().max()) < 0.002


def test_noise_is_deterministic_per_key_and_independent_per_seed():
    patch = _noise_patch(seed=1)
    params = stt.presets.farm_params(patch, 3)
    a, _, _ = stt.render_batch(patch, 256, params=params, key=7,
                               device="cpu")
    b, _, _ = stt.render_batch(patch, 256, params=params, key=7,
                               device="cpu")
    c, _, _ = stt.render_batch(patch, 256, params=params, key=8,
                               device="cpu")
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)
    # voices that share a seed draw different rows
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])
    # another seed: other lanes under the same key
    other = {mid: dict(pd) for mid, pd in params.items()}
    noise = next(i.id for i in patch if i.name == "noise")
    other[noise]["seed"] = torch.tensor([1, 2, 1])
    d, _, _ = stt.render_batch(patch, 256, params=other, key=7,
                               device="cpu")
    assert not torch.equal(d[1], a[1])
    assert not torch.equal(d[1], d[0]) and not torch.equal(d[1], d[2])
    # unbatched: the same key gives the same lane
    e, _, _ = stt.render(patch, 64, key=7, device="cpu")
    f, _, _ = stt.render(patch, 64, key=7, device="cpu")
    torch.testing.assert_close(e, f, atol=0, rtol=0)


def test_driver_lanes_from_numpy_and_note_tracks():
    patch, gate, cv = stt.presets.gate_cv_voice(
        stt.AudioConfig(sample_rate=4800, channels=1))
    events = [[("A4", 0.0, 0.02), ("C#5", 0.03, 0.02)],
              [(60, 0.005, 0.04)]]
    gates, cvs = stt.utils.note_tracks(events, 256, 4800)
    drivers = interop.drivers_from_numpy({gate: gates, cv: cvs})
    assert all(t.dtype == torch.float32 and tuple(t.shape) == (2, 256)
               for t in drivers.values())
    params = stt.replicate_params(patch.params(), 2)
    audio, _, _ = stt.render_batch(patch, 256, params=params,
                                   drivers=drivers, device="cpu")
    assert float(audio[:, :, 100:].abs().max()) > 0.01
    silent, _, _ = stt.render_batch(patch, 256, params=params,
                                    device="cpu")
    assert float(silent.abs().max()) == 0.0  # gate 0: no envelope
    np.testing.assert_allclose(cvs[0, 150], 1 - 8 / 12, rtol=1e-6)  # C#5
