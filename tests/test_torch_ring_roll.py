"""Kernel K9's plain version against the JAX package's ring alignment.

``ring_align`` (``srack_tpu_torch/ops/ring_roll.py``) runs, for CPU
tensors, its plain version, a ``torch.gather`` with the rotated index; for
CUDA tensors it launches K9 (``csrc/ring_align.cu``).  Here, on the CPU, the
plain version is held against the JAX package's Pallas kernel
``_align_rows`` in interpret mode (run by ``tests/torch_parity_worker.py``)
and against ``np.roll``, for several row counts and line lengths: exact.
The host build of K9 itself is checked in ``test_torch_block_host.py``;
here its entry is held against the plain version on the host (g++, the
same tile passes the card runs, thread by thread): the shared-memory tile
``srk_ring_align_tile`` at every tile length the wrapper takes, both
directions between rings and the Freeverb kernel's lines and rings to
rings, per-voice write indices (negative and out of range) and per-line
shifts, V of 1, 3 and 33, lines shorter and longer than a tile and not a
multiple of it: exact.
"""

import ctypes
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from srack_tpu_torch.ops import ring_roll as rr
from srack_tpu_torch.ops.cuda_lib import build
from srack_tpu_torch.ops.ring_roll import (RING_ALIGN, ring_align,
                                           ring_align_plain)

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_parity_worker.py"
SHAPES = ("3x5", "33x121", "7x178", "4x1")
HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
              "-shared", "-fPIC")
P, I = ctypes.c_void_p, ctypes.c_int
LENS = (1, 5, 31, 32, 33, 127, 129, 257, 300)   # around every tile length


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run([sys.executable, str(WORKER), str(out),
                           "ring_roll"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("shape", SHAPES)
def test_ring_align_matches_jax_kernel_and_np_roll(jax_ref, shape):
    buf = jax_ref[f"ring_roll/{shape}/buf"]
    idx = jax_ref[f"ring_roll/{shape}/idx"]
    got = ring_align(torch.from_numpy(buf), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, jax_ref[f"ring_roll/{shape}/out"])
    np.testing.assert_array_equal(
        got, np.stack([np.roll(b, -int(i)) for b, i in zip(buf, idx)]))


def test_ring_align_of_batched_rings_and_zero_index():
    rng = np.random.default_rng(3)
    buf = torch.from_numpy(rng.standard_normal((2, 3, 17)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 17, (2, 3)).astype(np.int32))
    got = ring_align_plain(buf, idx)
    for a in range(2):
        for b in range(3):
            assert torch.equal(got[a, b],
                               torch.roll(buf[a, b], -int(idx[a, b])))
    assert torch.equal(ring_align_plain(buf, torch.zeros_like(idx)), buf)


def test_ring_align_kernel_takes_cuda_tensors_only():
    """The CPU takes the plain version; the kernel's wrapper refuses CPU
    tensors instead of falling back, and counts nothing."""
    buf = torch.zeros((2, 5))
    idx = torch.tensor([1, 2], dtype=torch.int32)
    launches = RING_ALIGN.launches
    ring_align(buf, idx)
    with pytest.raises(ValueError, match="CUDA"):
        RING_ALIGN.move([buf], [torch.empty_like(buf)], (5,), 2,
                        idx=idx.reshape(1, 2))
    assert RING_ALIGN.launches == launches


# -- the tile against the plain version, on the host ---------------------------

@pytest.fixture(scope="module")
def host_k9(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ unavailable")
    path, _ = build(RING_ALIGN.source, compiler=gxx, flags=HOST_FLAGS,
                    root=tmp_path_factory.mktemp("k9"))
    return ctypes.CDLL(str(path))


def _host_move(lib, src, dst, v, idx, shifts, src_lines, dst_lines, tile):
    """K9's host entry with the wrapper's arguments and a tile length."""
    n = len(LENS)
    fn = lib.srk_ring_align_tile
    fn.restype = I
    fn.argtypes = [P] * 5 + [I] * 5
    assert fn((P * n)(*[t.data_ptr() for t in src]),
              (P * n)(*[t.data_ptr() for t in dst]), (I * n)(*LENS),
              (I * n)(*shifts), None if idx is None else idx.data_ptr(), n,
              v, int(src_lines), int(dst_lines), tile) == 0


@pytest.mark.parametrize("rotation", ["idx", "shift"])
@pytest.mark.parametrize("direction", ["rings->lines", "lines->rings",
                                       "rings->rings"])
@pytest.mark.parametrize("v", [1, 3, 33])
def test_ring_align_tile_on_host_matches_plain(host_k9, v, direction,
                                               rotation):
    src_lines = direction.startswith("lines")
    dst_lines = direction.endswith("lines")
    rng = np.random.default_rng(v)
    rings = [torch.from_numpy(rng.standard_normal((v, n)).astype(np.float32))
             for n in LENS]
    src = [r.T.contiguous() if src_lines else r for r in rings]
    idx, shifts = None, [0] * len(LENS)
    if rotation == "idx":
        idx = torch.from_numpy(rng.integers(-5000, 5000, (len(LENS), v))
                               .astype(np.int32))
    else:
        shifts = [int(x) for x in rng.integers(-5000, 5000, len(LENS))]

    want = []
    for j, n in enumerate(LENS):
        start = (idx[j].to(torch.int64) if idx is not None
                 else torch.zeros(v, dtype=torch.int64)) + shifts[j]
        want.append(ring_align_plain(rings[j], start % n))
    for tile in range(rr.TILE_MIN, rr.TILE_MAX + 1, 32):
        got = [torch.full((n, v) if dst_lines else (v, n), float("nan"))
               for n in LENS]
        _host_move(host_k9, src, got, v, idx, shifts, src_lines, dst_lines,
                   tile)
        for j in range(len(LENS)):
            assert torch.equal(got[j].T if dst_lines else got[j],
                               want[j]), (tile, j)
    assert RING_ALIGN.launches == 0


def test_ring_align_entries_and_their_wrappers(monkeypatch):
    """The main path's K9 is the tile (``srk_ring_align_tile``, 128
    positions); its wrapper refuses CPU tensors, and a tile length the
    kernel does not take raises before a launch."""
    assert RING_ALIGN.name == "ring_align" and RING_ALIGN.tile == 128
    assert 'extern "C" int srk_ring_align_tile(' in RING_ALIGN.source
    src, dst = [torch.zeros((2, 5))], [torch.zeros((2, 5))]
    with pytest.raises(ValueError, match="CUDA"):
        RING_ALIGN.move(src, dst, (5,), 2)
    monkeypatch.setattr(rr, "require_cuda", lambda *t: torch.device("cpu"))
    assert RING_ALIGN.call(src, dst, (5,), 2)[0] == "srk_ring_align_tile"
    for bad in (16, 100, 512):
        monkeypatch.setattr(RING_ALIGN, "tile", bad)
        with pytest.raises(ValueError, match="tile"):
            RING_ALIGN.call(src, dst, (5,), 2)
    assert RING_ALIGN.launches == 0
