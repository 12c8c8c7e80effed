"""WAV decode/encode (counterpart: ``srack_tpu/io/wav.py``; numpy only).

The reference decodes WAV via the ``hound`` crate for its sample player
(src/synth/sample.rs:32-69): float32 and int 8/16/24-bit formats, taking
**channel 0 only**, with int conversion ``x / (MAX+1)`` (i.e. /128, /32768,
/2^23).  This is an independent RIFF parser with the same semantics (the
native decoder of ``native/wav.cpp`` first, when its library builds), plus
a writer for render results (the reference has no export; its output is
the sound card).
"""

from __future__ import annotations

import struct

import numpy as np


def read_wav(path_or_bytes):
    """Decode a WAV file -> (samples_f32[channel 0], sample_rate).

    Mirrors the reference loader: PCM 8/16/24-bit int and 32-bit float,
    first channel only, int scaled by 1/(MAX+1) (sample.rs:49-53).
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    from ..native import wav_decode_native
    native = wav_decode_native(data)
    if native is not None:
        return native
    return decode_python(data)


def decode_python(data: bytes):
    """The pure-Python decode of a RIFF/WAVE byte string (what
    :func:`read_wav` runs when the native library is unavailable)."""
    fmt = None
    raw = None
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or raw is None:
        raise ValueError("missing fmt/data chunk")

    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE and len(raw) >= 0:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = 1 if bits != 32 else 3

    if audio_format == 3:
        samples = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    elif audio_format == 1:
        if bits == 8:
            # 8-bit WAV is unsigned with 128 bias
            u = np.frombuffer(raw, dtype=np.uint8).astype(np.int16) - 128
            samples = (u / 128.0).astype(np.float32)
        elif bits == 16:
            i = np.frombuffer(raw, dtype="<i2")
            samples = (i / 32768.0).astype(np.float32)
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            n = len(b) // 3
            b = b[:n * 3].reshape(n, 3)
            i = (b[:, 0].astype(np.int32)
                 | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            i = np.where(i >= 1 << 23, i - (1 << 24), i)
            samples = (i / float(1 << 23)).astype(np.float32)
        elif bits == 32:
            i = np.frombuffer(raw, dtype="<i4")
            samples = (i / 2147483648.0).astype(np.float32)
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}")

    if channels > 1:
        samples = samples[::channels]  # channel 0 only (sample.rs:42,59)
    return np.ascontiguousarray(samples), int(sample_rate)


def write_wav(path, audio, sample_rate: int, *, bits: int = 16):
    """Encode [channels, n] or [n] float32 audio (a numpy array or a
    tensor on any device) as PCM WAV."""
    if hasattr(audio, "detach"):
        audio = audio.detach().cpu().numpy()
    a = np.asarray(audio, dtype=np.float32)
    if a.ndim == 1:
        a = a[None, :]
    channels, n = a.shape
    interleaved = a.T.reshape(-1)
    if bits == 16:
        pcm = np.clip(np.round(interleaved * 32767.0), -32768, 32767)
        body = pcm.astype("<i2").tobytes()
        fmt_code, block = 1, channels * 2
    elif bits == 32:
        body = interleaved.astype("<f4").tobytes()
        fmt_code, block = 3, channels * 4
    else:
        raise ValueError("bits must be 16 or 32")
    hdr = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, fmt_code, channels,
                                 sample_rate, sample_rate * block, block, bits)
    hdr += b"data" + struct.pack("<I", len(body))
    if hasattr(path, "write"):  # file-like (e.g. BytesIO, pipe)
        path.write(hdr + body)
    else:
        with open(path, "wb") as f:
            f.write(hdr + body)
