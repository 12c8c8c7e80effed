"""ctypes bindings for the host runtime's C++ pieces (counterpart:
``srack_tpu/native.py``).

The execution planner and the WAV codec have C++ implementations
(``native/planner.cpp``, ``native/wav.cpp`` at the repository root) beside
their pure-Python forms (``planner.py``, ``io/wav.py``), which give the
same results.  The library is built with g++ at first use into
``build/srack_tpu_torch/native/<hash>/`` (the hash covers the sources and
the flags); when g++ or the sources are missing, or the build fails,
:func:`lib` is None and the Python forms run.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
SOURCES = tuple(_ROOT / "native" / s for s in ("planner.cpp", "wav.cpp"))
BUILD_DIR = _ROOT / "build" / "srack_tpu_torch" / "native"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def build() -> Path | None:
    """Build (or reuse) the shared library; None when it cannot be built."""
    if not all(s.exists() for s in SOURCES):
        return None
    key = hashlib.sha256("\0".join(
        [s.read_text() for s in SOURCES] + list(FLAGS)).encode()).hexdigest()
    out_dir = BUILD_DIR / key[:16]
    out = out_dir / "libsrack_native.so"
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = ["g++", *FLAGS, *[str(s) for s in SOURCES], "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return None
    os.replace(tmp, out)   # atomic: concurrent builders each write their own
    return out


@functools.cache
def lib():
    """The loaded native library, or None (the Python forms run)."""
    path = build()
    if path is None:
        return None
    try:
        L = ctypes.CDLL(str(path))
    except OSError:
        return None
    L.srack_plan_execution.restype = ctypes.c_int
    L.srack_plan_execution.argtypes = [
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    L.srack_wav_decode.restype = ctypes.c_int
    L.srack_wav_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
    L.srack_interleave_i16.restype = None
    L.srack_interleave_i16.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int16)]
    return L


def plan_execution_native(module_ids, deps_by_module, output_id):
    """Native planner over id lists.  Returns ``(plan_ids, broken_pairs)``
    or None when the library is unavailable or overflows."""
    L = lib()
    if L is None:
        return None
    idx = {mid: i for i, mid in enumerate(module_ids)}
    n = len(module_ids)
    offsets = np.zeros(n + 1, dtype=np.int32)
    flat = []
    for i, mid in enumerate(module_ids):
        for d in deps_by_module[mid]:
            flat.append(idx[d])
        offsets[i + 1] = len(flat)
    deps = np.asarray(flat if flat else [0], dtype=np.int32)
    plan = np.zeros(n, dtype=np.int32)
    max_broken = max(16, len(flat))
    broken = np.zeros(2 * max_broken, dtype=np.int32)
    n_broken = ctypes.c_int(0)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))

    emitted = L.srack_plan_execution(
        n, idx[output_id], ptr(offsets), ptr(deps), ptr(plan), ptr(broken),
        max_broken, ctypes.byref(n_broken))
    if emitted != n:
        return None  # overflow or stall: the Python planner runs
    plan_ids = [module_ids[i] for i in plan]
    broken_pairs = {
        (module_ids[broken[2 * k]], module_ids[broken[2 * k + 1]])
        for k in range(n_broken.value)}
    return plan_ids, broken_pairs


def wav_decode_native(data: bytes):
    """Native WAV decode -> ``(samples_f32, sample_rate)`` or None."""
    L = lib()
    if L is None:
        return None
    n = ctypes.c_int64(0)
    sr = ctypes.c_int32(0)
    if L.srack_wav_decode(data, len(data), None, ctypes.byref(n),
                          ctypes.byref(sr)) != 0:
        return None
    out = np.zeros(n.value, dtype=np.float32)
    if L.srack_wav_decode(
            data, len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(n), ctypes.byref(sr)) != 0:
        return None
    return out[:n.value], int(sr.value)


def interleave_i16(planar: np.ndarray) -> np.ndarray:
    """``[channels, n]`` f32 -> interleaved int16 PCM (native when
    available)."""
    planar = np.ascontiguousarray(planar, dtype=np.float32)
    c, n = planar.shape
    L = lib()
    if L is None:
        pcm = np.clip(np.round(planar * 32767.0), -32768, 32767)
        return pcm.T.reshape(-1).astype(np.int16)
    out = np.zeros(c * n, dtype=np.int16)
    L.srack_interleave_i16(
        planar.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), c, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    return out
