"""The port's command line, ``python -m srack_tpu_torch`` (the twin of
``tests/test_cli.py``), run in-process (``main(argv)``) with
``--device cpu``; and once as a module, its WAV of the sine preset equal
to the JAX CLI's at 16 bits (``tests/torch_parity_worker.py``, case
``cli_sine``)."""

import os
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest

from srack_tpu_torch.__main__ import main
from srack_tpu_torch.io.wav import read_wav

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_parity_worker.py"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def run_cli(argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_modules_listing(capsys):
    rc, out = run_cli(["modules"], capsys)
    assert rc == 0
    for name in ("Oscillator", "Moog Filter", "ADSR", "Grid Sequencer",
                 "Freeverb", "Add"):
        assert name in out
    assert "Sawtooth" in out


def test_presets_listing(capsys):
    rc, out = run_cli(["presets"], capsys)
    assert rc == 0
    for name in ("sine", "subtractive", "sequencer", "feedback", "drums"):
        assert name in out


def test_render_preset_to_wav(tmp_path, capsys):
    out_path = tmp_path / "sine.wav"
    rc, _ = run_cli(["render", "sine", "-o", str(out_path), "--samples",
                     "4096", "--device", "cpu"], capsys)
    assert rc == 0
    audio, sr = read_wav(str(out_path))
    assert sr == 48000 and audio.shape[-1] == 4096
    assert 0.9 < np.abs(audio).max() <= 1.0


def test_module_cli_writes_the_jax_cli_wav(tmp_path):
    """``python -m srack_tpu_torch render sine`` writes the bytes the JAX
    CLI writes (16-bit PCM of the same 4,096 samples)."""
    out = tmp_path / "ref.npz"
    proc = subprocess.run([sys.executable, str(WORKER), str(out),
                           "cli_sine"], capture_output=True, text=True,
                          env=_env(), timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = np.load(out)["cli_sine/wav"].tobytes()
    port = tmp_path / "port.wav"
    proc = subprocess.run([sys.executable, "-m", "srack_tpu_torch", "render",
                           "sine", "--samples", "4096", "-o", str(port),
                           "--device", "cpu"], capture_output=True,
                          text=True, env=_env(), cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert port.read_bytes() == want


def test_render_srk_roundtrip(tmp_path, capsys):
    from srack_tpu_torch.io.srk import write_srk
    from srack_tpu_torch.presets import subtractive_voice

    srk = tmp_path / "voice.srk"
    write_srk(subtractive_voice(), str(srk))
    out_path = tmp_path / "voice.wav"
    rc, _ = run_cli(["render", str(srk), "-o", str(out_path), "--samples",
                     "2048", "--device", "cpu"], capsys)
    assert rc == 0
    audio, _ = read_wav(str(out_path))
    assert audio.shape[-1] == 2048


def test_render_with_override_keeps_wiring(tmp_path, capsys):
    out_path = tmp_path / "sine44.wav"
    rc, _ = run_cli(["render", "sine", "-o", str(out_path), "--sample-rate",
                     "44100", "--samples", "4096", "--device", "cpu"],
                    capsys)
    assert rc == 0
    audio, sr = read_wav(str(out_path))
    assert sr == 44100
    assert np.abs(audio).max() > 0.5


def test_render_channel_upscale_mirrors(tmp_path, capsys):
    out_path = tmp_path / "sine2ch.wav"
    rc, _ = run_cli(["render", "sine", "-o", str(out_path), "--channels",
                     "2", "--samples", "2048", "--device", "cpu"], capsys)
    assert rc == 0
    raw = out_path.read_bytes()
    assert struct.unpack("<H", raw[22:24])[0] == 2
    pcm = np.frombuffer(raw[44:], dtype="<i2").reshape(-1, 2)
    assert np.abs(pcm[:, 1]).max() > 1000
    np.testing.assert_array_equal(pcm[:, 0], pcm[:, 1])


def test_info_shows_plan_and_feedback(capsys):
    rc, out = run_cli(["info", "feedback"], capsys)
    assert rc == 0
    assert "config: 48000 Hz" in out
    assert "plan:" in out
    assert "feedback edges" in out
    assert "connections" in out


def test_unknown_source_errors(capsys):
    with pytest.raises(SystemExit):
        main(["render", "no_such_preset_xyz", "--device", "cpu"])
