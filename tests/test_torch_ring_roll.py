"""Kernel K9's plain version against the JAX package's ring alignment.

``ring_align`` (``srack_tpu_torch/ops/ring_roll.py``) runs, for CPU
tensors, its plain version, a ``torch.gather`` with the rotated index; for
CUDA tensors it launches K9 (``csrc/ring_align.cu``).  Here, on the CPU, the
plain version is held against the JAX package's Pallas kernel
``_align_rows`` in interpret mode (run by ``tests/torch_parity_worker.py``)
and against ``np.roll``, for several row counts and line lengths: exact.
The host build of K9 itself is checked in ``test_torch_block_host.py``.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from srack_tpu_torch.ops.ring_roll import (RING_ALIGN, ring_align,
                                           ring_align_plain)

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_parity_worker.py"
SHAPES = ("3x5", "33x121", "7x178", "4x1")


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
