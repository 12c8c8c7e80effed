"""The row gather's plain version against the JAX package's kernels K5 and
K6 in interpret mode, on the CPU.

* ``table_lookup_rows`` (on CPU tensors: ``table_lookup_rows_plain``, one
  ``torch.gather``) against K5 (``scan_kernel._gather_rows``) for tables of
  16, 64 and 400 entries, f32 and int32, and against K6
  (``sample_gather._gather_rows``, f32 tables: it returns f32) for 400 and
  5,000 frames, on monotone ramps with restarts and on uniform random
  indices, 4 rows x 2,100: exact for indices in range.
* A reference quirk, recorded: for an index at or past K, JAX's K5
  answers ``table[0]`` (its select chain starts from entry 0), while the
  JAX select tree -- which the JAX step, and the JAX block form off the
  TPU, use -- answers with the index's low bits.  The port follows the
  select tree everywhere; the test pins the port's answer against the
  JAX step's and K5's difference from it.

The JAX results come from ``tests/torch_parity_worker.py``.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srack_tpu.ops import basic as jbasic

from srack_tpu_torch.ops import basic
from srack_tpu_torch.ops.gather_kernel import ROW_GATHER, ROW_GATHER_LONG

from test_torch_slice import ROOT, WORKER, _env

K5_CASES = [(k, dt) for k in (16, 64, 400) for dt in ("f32", "i32")]
K6_CASES = ["400_ramp", "5000_ramp", "5000_uniform"]


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    proc = subprocess.run([sys.executable, str(WORKER), str(out), "gather"],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("k,dt", K5_CASES)
def test_plain_matches_jax_k5(jax_ref, k, dt):
    tag = f"gather/k5_{k}_{dt}"
    got = basic.table_lookup_rows(_t(jax_ref[f"{tag}/table"]),
                                  _t(jax_ref[f"{tag}/idx"]))
    want = jax_ref[f"{tag}/out"]
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", K6_CASES)
def test_plain_matches_jax_k6(jax_ref, case):
    tag = f"gather/k6_{case}"
    got = basic.table_lookup_rows(_t(jax_ref[f"{tag}/table"]),
                                  _t(jax_ref[f"{tag}/idx"]), long=True)
    np.testing.assert_array_equal(got.numpy(), jax_ref[f"{tag}/out"])


@pytest.mark.parametrize("k", [16, 64, 400])
def test_past_the_table_follows_the_select_tree_not_k5(jax_ref, k):
    """The recorded quirk: at indices in [K, 2K + 5) K5 gives table[0]; the
    JAX select tree (the step's lookup) and the port give the low bits'
    entry, padded with the last."""
    tag = f"gather/k5_{k}_i32"
    table, past = jax_ref[f"{tag}/table"], jax_ref[f"{tag}/past"]
    got = basic.table_lookup_rows(_t(table), _t(past)).numpy()
    tree = np.stack([np.asarray(jbasic.table_lookup(jnp.asarray(table[r]),
                                                    jnp.asarray(past[r])))
                     for r in range(table.shape[0])])
    np.testing.assert_array_equal(got, tree)
    k5 = jax_ref[f"{tag}/out_past"]
    np.testing.assert_array_equal(k5, np.broadcast_to(table[:, :1],
                                                      k5.shape))
    assert (k5 != got).mean() > 0.5


def test_wrappers_take_cpu_tensors_to_the_plain_version_only():
    """On CPU tensors the whole-row lookup runs its plain version and never
    a kernel; a kernel wrapper given CPU tensors raises (no fallback)."""
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-50, 90, (3, 77)).astype(np.int32))
    want = torch.stack([basic.table_lookup(table[r], idx[r])
                        for r in range(3)])
    for long in (None, False, True):
        assert torch.equal(basic.table_lookup_rows(table, idx, long=long),
                           want)
    for kernel in (ROW_GATHER, ROW_GATHER_LONG):
        with pytest.raises(ValueError, match="CUDA"):
            kernel.run(table, idx)
        assert kernel.launches == 0
