"""The port's ``io``: WAV codec, JSON patches, state snapshots and ``.srk``
interop, against the JAX package's (the twin of ``tests/test_io.py``).

* ``read_wav`` of 8-, 16- and 24-bit int and 32-bit float files equals
  JAX's exactly, and ``write_wav`` at 16 and 32 bits writes JAX's bytes.
* JSON patches and state snapshots round-trip; ``load_state`` keeps each
  leaf's dtype, so an exact patch's f64 leaves come back f64.
* The ``.srk`` fixture (``tests/data/reference_all_modules.srk``, bytes
  the readers did not write) loads in both packages to the same modules,
  ids, params and wiring, and renders within 1e-5 of the JAX scan engine
  (``tests/torch_parity_worker.py``, case ``srk_fixture``, the Noise fed
  one numpy lane).  ``write_srk`` output read by the other package's
  ``read_srk`` gives the same patch, both ways; the fuzz, truncation,
  bit-flip and malformed-input cases of the JAX tests hold.
"""

import importlib.util
import os
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import srack_tpu as st
import srack_tpu.io as jio

import srack_tpu_torch as stt
from srack_tpu_torch.io import (load_patch, load_state, read_srk, read_wav,
                                save_patch, save_state, write_srk, write_wav)
from srack_tpu_torch.io.srk import SrkError

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_parity_worker.py"
FIXTURE = ROOT / "tests" / "data" / "reference_all_modules.srk"
EXACT = stt.AudioConfig(sample_rate=4800, block_size=64, channels=1,
                        precision="exact")


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_io") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run([sys.executable, str(WORKER), str(out),
                           "srk_fixture"], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def test_wav_roundtrip_16bit(tmp_path):
    sr = 8000
    x = (0.5 * np.sin(np.linspace(0, 100, 4000))).astype(np.float32)
    path = tmp_path / "t.wav"
    write_wav(path, torch.from_numpy(x), sr)
    y, sr2 = read_wav(path)
    assert sr2 == sr
    np.testing.assert_allclose(y, x, atol=1.0 / 32000)


def test_wav_roundtrip_float_stereo_takes_channel0(tmp_path):
    sr = 44100
    a = np.stack([np.linspace(-1, 1, 100), np.zeros(100)]).astype(np.float32)
    path = tmp_path / "t.wav"
    write_wav(path, a, sr, bits=32)
    y, _ = read_wav(path)
    np.testing.assert_allclose(y, a[0], atol=1e-7)  # channel 0 only


def _pcm_wav(code: int, bits: int, channels: int, body: bytes,
             sr: int = 22050) -> bytes:
    block = channels * bits // 8
    return (b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, code, channels, sr,
                                    sr * block, block, bits)
            + b"data" + struct.pack("<I", len(body)) + body)


@pytest.mark.parametrize("kind", ["int8", "int16", "int24", "float32"])
def test_read_wav_equals_jax(kind):
    rng = np.random.default_rng(11)
    n, ch = 301, 2
    if kind == "int8":
        data = _pcm_wav(1, 8, ch, rng.integers(0, 256, n * ch,
                                               dtype=np.uint8).tobytes())
    elif kind == "int16":
        data = _pcm_wav(1, 16, ch, rng.integers(-32768, 32768, n * ch)
                        .astype("<i2").tobytes())
    elif kind == "int24":
        data = _pcm_wav(1, 24, ch, rng.integers(0, 256, n * ch * 3,
                                                dtype=np.uint8).tobytes())
    else:
        data = _pcm_wav(3, 32, ch, rng.uniform(-1, 1, n * ch)
                        .astype("<f4").tobytes())
    got, sr = read_wav(data)
    want, want_sr = jio.read_wav(data)
    assert sr == want_sr == 22050 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    py, _ = stt.io.wav.decode_python(data)
    np.testing.assert_array_equal(py, want)


@pytest.mark.parametrize("bits", [16, 32])
def test_write_wav_writes_jax_bytes(tmp_path, bits):
    a = np.random.default_rng(3).uniform(-1.2, 1.2, (2, 257)).astype(
        np.float32)
    write_wav(tmp_path / "port.wav", torch.from_numpy(a), 44100, bits=bits)
    jio.write_wav(tmp_path / "jax.wav", a, 44100, bits=bits)
    assert ((tmp_path / "port.wav").read_bytes()
            == (tmp_path / "jax.wav").read_bytes())


def test_patch_json_roundtrip(tmp_path):
    p = stt.presets.sequencer_patch(EXACT)
    path = tmp_path / "patch.json"
    save_patch(p, path)
    q = load_patch(path)
    assert sorted(q.module_ids) == sorted(p.module_ids)
    assert sorted(q.connections()) == sorted(p.connections())
    a, _, _ = stt.render(p, 256, device="cpu")
    b, _, _ = stt.render(q, 256, device="cpu")
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    # the JAX package reads the port's file to the same patch
    j = jio.load_patch(str(path))
    assert sorted(j.connections()) == sorted(p.connections())
    for inst in p:
        for k, v in inst.params.items():
            np.testing.assert_array_equal(np.asarray(j[inst.id].params[k]),
                                          v.numpy())


def test_state_snapshot_resume_keeps_f64(tmp_path):
    p = stt.presets.subtractive_voice(EXACT)
    compiled = stt.compile_patch(p)
    full, _, _ = compiled.render(256, device="cpu")
    a1, _, mid = compiled.render(128, device="cpu")
    save_state(tmp_path / "ck.npz", mid)
    restored = load_state(tmp_path / "ck.npz", compiled.init_state())
    f64 = [(k, m) for m, sd in restored["states"].items()
           for k, t in sd.items() if t.dtype == torch.float64]
    assert f64, "the exact Oscillators' phases are f64 leaves"
    for k, m in f64:
        assert mid["states"][m][k].dtype == torch.float64
        torch.testing.assert_close(restored["states"][m][k],
                                   mid["states"][m][k], atol=0, rtol=0)
    a2, _, _ = compiled.render(128, state=restored, device="cpu")
    torch.testing.assert_close(torch.cat([a1, a2], dim=-1), full,
                               atol=1e-7, rtol=0)
    with pytest.raises(ValueError, match="shape"):
        load_state(tmp_path / "ck.npz", stt.replicate_params(
            compiled.init_state(), 2))


def _all_module_patch(cfg, pkg):
    p = pkg.Patch(cfg)
    osc = p.add("Oscillator", val=-1.25)
    noise = p.add("Noise")
    gs = p.add("Grid Sequencer", sequence=[(3, True), None, (7, False)],
               n_steps=3)
    ps = p.add("Pattern Sequencer", pattern=[[True, None, False]] * 8,
               n_steps=3)
    env = p.add("ADSR", a_sec=0.1, d_sec=0.2, s_val=0.3, r_sec=0.4)
    vca = p.add("VCA")
    flt = p.add("Moog Filter", freq=0.33, res=0.66, exp_amt=0.1)
    mix = p.add("Mono Mixer", gains=(0.1, 0.2, 0.3, 0.4))
    smp = p.add("Sample", samples=np.linspace(-1, 1, 10).astype(np.float32),
                wav_sample_rate=22050)
    add = p.add("Add", constant=0.5)
    nl = p.add("Non-Linear", constant=1.5)
    rev = p.add("Freeverb", room_size=0.9, dampening=0.25, wet=0.7,
                width=0.4, dry=0.1)
    p.connect(osc, "Sine", flt, "Audio")
    p.connect(gs, "Gate", env, "Gate")
    p.connect(flt, 0, vca, "Audio")
    p.connect(env, 0, vca, "CV")
    p.connect(vca, 0, rev, "Left")
    p.connect(rev, "Left", p.output, 0)
    p.connect(rev, "Right", p.output, 1)
    p.connect(noise, 0, mix, 0)
    p.connect(smp, 0, mix, 1)
    p.connect(add, 0, nl, "In1")
    p.connect(ps, "0", add, "In1")
    return p


def _sig(patch):
    """Types, params and wiring of a patch, by id."""
    return ({i.id: (i.mdef.type_name,
                    {k: np.asarray(v).tolist() for k, v in i.params.items()})
             for i in patch}, sorted(patch.connections()))


def test_srk_roundtrip_all_module_types_and_across_packages():
    cfg = stt.AudioConfig(sample_rate=48000, block_size=64, channels=2,
                          precision="exact")
    p = _all_module_patch(cfg, stt)
    data = write_srk(p)
    q = read_srk(data, config=cfg)
    assert sorted(i.mdef.type_name for i in p) == sorted(
        i.mdef.type_name for i in q)
    assert len(q.connections()) == len(p.connections())
    q_gs = [i for i in q if i.mdef.type_name == "Grid Sequencer"][0]
    assert int(q_gs.params["n_steps"]) == 3
    assert q_gs.params["cells"][0] == 2 and q_gs.params["cells"][2] == 1
    a, _, _ = stt.render(p, 128, device="cpu")
    b, _, _ = stt.render(q, 128, device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    # the port's bytes are the JAX package's, and each reads the other's
    jcfg = st.AudioConfig(sample_rate=48000, block_size=64, channels=2,
                          precision="exact")
    jp = _all_module_patch(jcfg, st)
    assert jio.write_srk(jp) == data
    assert _sig(jio.read_srk(data, config=jcfg)) == _sig(q)
    assert _sig(read_srk(jio.write_srk(jp), config=cfg)) == _sig(q)


def test_srk_ground_truth_fixture_matches_jax(jax_ref):
    cfg = stt.AudioConfig(sample_rate=48000, block_size=16, channels=2)
    p = read_srk(FIXTURE, cfg)
    j = jio.read_srk(FIXTURE, st.AudioConfig(sample_rate=48000,
                                             block_size=16, channels=2))
    assert _sig(p) == _sig(j)
    assert [i.id for i in p] == [i.id for i in j]
    assert p.positions == j.positions and p.srk_ids == j.srk_ids
    by_type = {}
    for inst in p:
        by_type.setdefault(inst.mdef.type_name, []).append(inst)
    assert sorted(by_type) == [
        "ADSR", "Add", "Freeverb", "Grid Sequencer", "Mono Mixer",
        "Moog Filter", "Multiply", "Noise", "Non-Linear", "Oscillator",
        "Output", "Pattern Sequencer", "Sample", "Subtract", "VCA"]
    assert float(by_type["Oscillator"][0].params["val"]) == np.float32(-1.25)
    verb = by_type["Freeverb"][0]
    assert float(verb.params["wet"]) == np.float32(0.85)
    assert len(p.connections()) == 9 and len(p.positions) == 2
    drivers = {k.split("/")[-1]: v for k, v in jax_ref.items()
               if k.startswith("srk_fixture/drivers/")}
    audio, _, _ = stt.render(p, jax_ref["srk_fixture/audio"].shape[-1],
                             engine="scan", drivers=drivers, device="cpu")
    np.testing.assert_allclose(audio.numpy(), jax_ref["srk_fixture/audio"],
                               atol=1e-5, rtol=0)


def _random_patch(rng):
    """The JAX fuzz tests' randomized patch, every serializable variant
    with non-default values and random wiring."""
    cfg = stt.AudioConfig(sample_rate=int(rng.choice([44100, 48000])),
                          block_size=64, channels=2)
    p = stt.Patch(cfg)
    mods = [p.output]
    u = lambda a, b: float(rng.uniform(a, b))  # noqa: E731
    seq = [None if rng.random() < 0.3 else
           (int(rng.integers(0, 48)), bool(rng.random() < 0.5))
           for _ in range(int(rng.integers(2, 17)))]
    pat = [[(None if rng.random() < 0.5 else bool(rng.random() < 0.5))
            for _ in range(8)] for _ in range(int(rng.integers(1, 9)))]
    adds = [
        ("Oscillator", dict(val=u(-9, 6),
                            antialiasing=bool(rng.random() < 0.5))),
        ("Noise", {}),
        ("Moog Filter", dict(freq=u(0, 1), res=u(0, 1),
                             exp_amt=u(2 ** -8, 1))),
        ("ADSR", dict(a_sec=u(0, 1), d_sec=u(0, 1), s_val=u(0, 1),
                      r_sec=u(0, 1))),
        ("VCA", dict(negative=bool(rng.random() < 0.5))),
        ("Mono Mixer", dict(gains=tuple(u(0, 2) for _ in range(4)))),
        ("Add", dict(constant=u(-2, 2))),
        ("Subtract", dict(constant=u(-2, 2))),
        ("Multiply", dict(constant=u(-2, 2))),
        ("Non-Linear", dict(constant=u(0.5, 2))),
        ("Grid Sequencer", dict(sequence=seq, n_steps=len(seq),
                                octaves=int(rng.integers(1, 5)),
                                steps_per_octave=12)),
        ("Pattern Sequencer", dict(pattern=pat, n_steps=8)),
        ("Sample", dict(samples=rng.normal(size=int(rng.integers(1, 200)))
                        .astype(np.float32),
                        wav_sample_rate=float(rng.choice([22050, 44100])))),
        ("Freeverb", dict(dampening=u(0, 2), freeze=bool(rng.random() < 0.2),
                          wet=u(0, 1), width=u(0, 1), room_size=u(0, 1),
                          dry=u(0, 1))),
    ]
    rng.shuffle(adds)
    for name, kwargs in adds:
        if rng.random() < 0.8:
            mods.append(p.add(name, **kwargs))
    for sink in mods:
        inst = p[sink]
        for port in range(len(inst.inputs)):
            if rng.random() < 0.5 and len(mods) > 1:
                src = mods[int(rng.integers(0, len(mods)))]
                n_out = p[src].mdef.num_outputs(cfg, p[src].statics)
                if n_out and src.id != sink.id:
                    p.connect(src, int(rng.integers(0, n_out)), sink, port)
    return p


def test_srk_fuzz_roundtrip():
    """write -> read -> write is byte-stable and keeps params and wiring
    over 20 randomized patches; the JAX reader gets the same patch."""
    for seed in range(20):
        p = _random_patch(np.random.default_rng(seed))
        data = write_srk(p)
        q = read_srk(data, config=p.config)
        assert write_srk(q) == data, f"seed {seed}: second write differs"

        def sig(patch):
            return sorted(((i.mdef.type_name,
                            sorted({k: np.asarray(v).tolist()
                                    for k, v in i.params.items()}.items(),
                                   key=str)) for i in patch), key=str)
        assert sig(q) == sig(p), f"seed {seed}: params drifted"
        assert len(q.connections()) == len(p.connections()), f"seed {seed}"
        cfg = p.config
        j = jio.read_srk(data, config=st.AudioConfig(
            sample_rate=cfg.sample_rate, block_size=cfg.block_size,
            channels=cfg.channels))
        assert _sig(j) == _sig(q), f"seed {seed}: the JAX reader differs"


def test_srk_truncated_bytes_rejected():
    p = _random_patch(np.random.default_rng(1))
    data = write_srk(p)
    for cut in range(1, len(data), max(1, len(data) // 40)):
        try:
            read_srk(data[:cut], config=p.config)
        except (SrkError, ValueError):
            pass  # graceful rejection (or, rarely, a valid prefix parse)


def test_srk_bitflips_never_crash_ungracefully():
    p = _random_patch(np.random.default_rng(2))
    data = bytearray(write_srk(p))
    rng = np.random.default_rng(3)
    for _ in range(60):
        mutated = bytearray(data)
        i = int(rng.integers(0, len(mutated)))
        mutated[i] ^= 1 << int(rng.integers(0, 8))
        try:
            read_srk(bytes(mutated), config=p.config)
        except (SrkError, ValueError):
            pass  # anything else (IndexError/KeyError/TypeError) fails


def test_srk_malformed_structures_rejected():
    import msgpack
    cases = [
        msgpack.packb("hello"),
        msgpack.packb([[], []]),
        msgpack.packb([[{"NopeModuleV9": ["x"]}], [], []]),
        msgpack.packb([[{"OscillatorModuleV0": ["id"]}], [], []]),
        msgpack.packb([[{"a": 1, "b": 2}], [], []]),
        msgpack.packb([["notamap"], [], []]),
        msgpack.packb([[], [["a", 0, "b"]], []]),
        msgpack.packb([[], [], "positions?"]),
        msgpack.packb([[{"ADSRModuleV0": ["id", "NaNstr", 0, 0, 0]}], [], []]),
    ]
    for data in cases:
        with pytest.raises((SrkError, ValueError)):
            read_srk(data)


def test_independent_encoders_read_to_one_patch():
    """The fixture generator's hand-assembled emitter and the ``msgpack``
    wheel give bytes that the port reads to the same patch as the
    checked-in fixture."""
    gen = ROOT / "tests" / "data" / "make_srk_fixtures.py"
    spec = importlib.util.spec_from_file_location("make_srk_fixtures", gen)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = stt.AudioConfig(sample_rate=48000, block_size=16, channels=2)
    want = _sig(read_srk(FIXTURE, cfg))
    for emit in (mod.Emit, mod.MsgpackEmit):
        assert _sig(read_srk(mod.build(emit), cfg)) == want
