"""The port's native host runtime (the twin of ``tests/test_native.py``):
the C++ planner and WAV codec of ``native/``, built by
``srack_tpu_torch.native`` with g++, agree with their pure-Python forms and
with the JAX package's planner."""

import random

import numpy as np
import pytest

import srack_tpu as st

import srack_tpu_torch as stt
from srack_tpu_torch import native
from srack_tpu_torch.io.wav import decode_python, write_wav
from srack_tpu_torch.planner import plan_execution


@pytest.fixture(scope="module")
def lib():
    found = native.lib()
    assert found is not None, "g++ could not build native/*.cpp"
    return found


def random_patch(rng, n_modules=10, n_edges=14):
    p = stt.Patch(stt.AudioConfig(channels=2))
    mods = [p.add("Mono Mixer") for _ in range(n_modules)]
    everyone = mods + [p.output]
    for _ in range(n_edges):
        src = rng.choice(mods)
        sink = rng.choice(everyone)
        free = [i for i, c in enumerate(p[sink].inputs) if c is None]
        if free:
            p.connect(src, 0, sink, free[0])
    return p


def test_native_planner_matches_python_randomized(lib):
    rng = random.Random(7)
    for trial in range(60):
        p = random_patch(rng, n_modules=rng.randint(2, 14),
                         n_edges=rng.randint(0, 24))
        plan_py, broken_py = plan_execution(p, use_native=False)
        plan_nat, broken_nat = plan_execution(p, use_native=True)
        assert plan_nat == plan_py, f"trial {trial}"
        assert broken_nat == broken_py, f"trial {trial}"


@pytest.mark.parametrize("name", sorted(stt.presets.PRESETS))
def test_native_planner_matches_python_and_jax_on_presets(lib, name):
    p = stt.presets.PRESETS[name](None)
    want = plan_execution(p, use_native=False)
    assert plan_execution(p, use_native=True) == want
    assert st.plan_execution(st.presets.PRESETS[name](None),
                             use_native=False) == want


def test_native_wav_decode_matches_python(lib, tmp_path):
    sr = 22050
    x = (np.sin(np.linspace(0, 60, 1000)) * 0.9).astype(np.float32)
    for bits in (16, 32):
        path = tmp_path / f"t{bits}.wav"
        write_wav(path, np.stack([x, -x]), sr, bits=bits)
        data = path.read_bytes()
        got, got_sr = native.wav_decode_native(data)
        want, want_sr = decode_python(data)
        assert got_sr == want_sr == sr
        np.testing.assert_array_equal(got, want)


def test_native_interleave(lib):
    planar = np.asarray([[0.0, 0.5, -1.2], [1.0, -0.5, 0.25]],
                        dtype=np.float32)
    out = native.interleave_i16(planar)
    assert out.dtype == np.int16
    assert list(out) == [0, 32767, 16384, -16384, -32768, 8192]
