"""The port's real-time playback (the twin of ``tests/test_play.py``):
``play`` over ``render_stream`` with the wav and null sinks, on the CPU
(``device="cpu"``); the device sink needs ``sounddevice``.

The port's CPU path is the scan engine, a Python loop that costs about
0.3 ms a sample here, so the patch runs at 600 Hz in blocks of 128 (213
ms): about the 4x real-time headroom the JAX test has at 2,400 Hz."""

import numpy as np
import pytest

import srack_tpu_torch as stt
from srack_tpu_torch.io import read_wav

CFG = stt.AudioConfig(sample_rate=600, block_size=128, channels=1,
                      precision="fast")


def _patch():
    p = stt.Patch(CFG)
    osc = p.add("Oscillator", val=-1.0)
    p.connect(osc, "Sine", p.output, 0)
    return p


def test_play_null_sink_accounting():
    stats = stt.play(_patch(), seconds=2.0, sink="null", device="cpu")
    assert isinstance(stats, stt.PlayStats)
    assert stats.underruns == 0, (stats.underruns, stats.worst_headroom_s)
    assert stats.blocks == int(2.0 / (CFG.block_size / CFG.sample_rate)) - 2
    assert stats.ok


def test_play_wav_sink_writes_file(tmp_path):
    out = tmp_path / "played.wav"
    stt.play(_patch(), seconds=1.0, sink="wav", out_path=str(out),
             device="cpu")
    data, sr = read_wav(str(out))
    assert sr == CFG.sample_rate
    n_blocks = int(1.0 / (CFG.block_size / CFG.sample_rate))
    assert data.shape[-1] == n_blocks * CFG.block_size
    assert float(np.abs(data).max()) > 0.01
    # the blocks are the stream's: the 16-bit PCM of one render of the
    # same length, read back
    want, _, _ = stt.render(_patch(), n_blocks * CFG.block_size,
                            device="cpu")
    pcm = np.clip(np.round(want[0].numpy() * 32767.0), -32768, 32767)
    np.testing.assert_array_equal(data, (pcm / 32768.0).astype(np.float32))


def test_play_batched_monitor_mix(tmp_path):
    out = tmp_path / "batch.wav"
    stats = stt.play(_patch(), seconds=1.0, sink="wav", voices=4,
                     out_path=str(out), device="cpu")
    assert stats.blocks >= 1
    data, _ = read_wav(str(out))
    assert data.ndim == 1 and data.shape[0] > 0


def test_play_device_raises_when_unavailable():
    try:
        import sounddevice  # noqa: F401
        pytest.skip("sounddevice present; the device sink would open")
    except ImportError:
        pass
    with pytest.raises(Exception):
        stt.play(_patch(), seconds=0.1, sink="device", device="cpu")
