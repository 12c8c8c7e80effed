"""The row-scan wrappers' plain versions against the JAX package.

The wrappers of ``srack_tpu_torch/ops/basic.py`` (``fast_cumsum``,
``fast_cummax``, ``forward_fill``, ``forward_fill_multi``,
``monotone_fill``, ``affine_scan``, ``linear_recurrence``) run, for CPU
tensors, the log-doubling forms that are kernel K4's plain version; for
CUDA tensors they launch K4 (``csrc/row_scan.cu``).  Here, on ``[3,
2,500]`` rows from a numpy seed (two of K4's 1,024-element chunks and a
part, so its carried prefix is used on the card), the plain versions are
held against

* the JAX wrappers off the TPU (their log-doubling forms, the same passes),
* kernel K4 of the JAX package in interpret mode (``_scan_rows``),

both run by ``tests/torch_parity_worker.py``.  int32 sums, the maxes and
the fills exact (a fill where a value is defined), f32 sums within
``2e-4`` and affine scans within ``3e-4``, ``tests/test_scan_kernel.py``'s
tolerances.  The host build of K4 is checked in
``test_torch_block_host.py``.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from srack_tpu_torch.ops import basic
from srack_tpu_torch.ops.scan_kernel import ROW_SCAN

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_parity_worker.py"
TOL = {"sum_f32": 2e-4, "affine_f32": 3e-4, "linrec_f32": 3e-4}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run([sys.executable, str(WORKER), str(out), "scan"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _port(kind, x):
    """The port's wrapper for ``kind`` on the worker's inputs (CPU: the
    plain versions), as a tuple of numpy arrays."""
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    res = {
        "sum_f32": lambda: (basic.fast_cumsum(t["xf"]),),
        "sum_i32": lambda: (basic.fast_cumsum(t["xi"]),),
        "max_f32": lambda: (basic.fast_cummax(t["xf"]),),
        "max_i32": lambda: (basic.fast_cummax(t["xi"]),),
        "fill_f32": lambda: basic.forward_fill_multi((t["xf"], t["yf"]),
                                                     t["mask"]),
        "fill_i32": lambda: basic.forward_fill(t["xi"], t["mask"]),
        "affine_f32": lambda: basic.affine_scan(t["a"], t["b"]),
        "monotone_i32": lambda: basic.monotone_fill(t["mono"], t["mask"]),
        "linrec_f32": lambda: basic.linear_recurrence(0.95, t["b"]),
    }[kind]()
    flat = []
    for r in res:
        flat += list(r) if isinstance(r, tuple) else [r]
    return [a.numpy() for a in flat]


def _assert_matches(kind, got, want, ok=None):
    if kind in TOL:
        np.testing.assert_allclose(got, want, rtol=TOL[kind], atol=TOL[kind])
    elif ok is not None:   # a fill: exact where a value is defined
        np.testing.assert_array_equal(got[ok], want[ok])
    else:
        np.testing.assert_array_equal(got, want)


def _inputs(ref):
    return {k[len("scan/in/"):]: v for k, v in ref.items()
            if k.startswith("scan/in/")}


@pytest.mark.parametrize("kind", ["sum_f32", "sum_i32", "max_f32",
                                  "max_i32", "fill_f32", "fill_i32",
                                  "affine_f32", "monotone_i32",
                                  "linrec_f32"])
def test_plain_wrapper_matches_jax_wrapper(jax_ref, kind):
    got = _port(kind, _inputs(jax_ref))
    want = [jax_ref[f"scan/wrap/{kind}/{i}"] for i in range(len(got))]
    fill = kind.startswith("fill") or kind.startswith("monotone")
    ok = want[-1] if fill else None
    if fill:
        np.testing.assert_array_equal(got[-1], ok)
    for g, w in zip(got[:-1] if fill else got, want):
        _assert_matches(kind, g, w, ok)


@pytest.mark.parametrize("kind", ["sum_f32", "sum_i32", "max_f32",
                                  "max_i32", "fill_f32", "fill_i32",
                                  "affine_f32"])
def test_plain_wrapper_matches_jax_k4_interpret(jax_ref, kind):
    got = _port(kind, _inputs(jax_ref))
    want = [jax_ref[f"scan/k4/{kind}/{i}"] for i in range(len(got))]
    if kind.startswith("fill"):
        ok = want[-1] != 0
        np.testing.assert_array_equal(got[-1], ok)
        for g, w in zip(got[:-1], want):
            _assert_matches(kind, g, w, ok)
        return
    for g, w in zip(got, want):
        _assert_matches(kind, g, w)


def test_linear_recurrence_solves_the_recurrence():
    rng = np.random.default_rng(2)
    b = torch.from_numpy(rng.standard_normal((2, 700)).astype(np.float32))
    a, y0 = 0.9, torch.tensor([[0.5], [-1.0]])
    A, Y = basic.linear_recurrence(a, b)
    y, want = y0[:, 0].clone(), []
    for t in range(b.shape[1]):
        y = a * y + b[:, t]
        want.append(y)
    torch.testing.assert_close(A * y0 + Y, torch.stack(want, dim=1),
                               rtol=3e-4, atol=3e-4)


def test_scan_wrappers_take_cuda_tensors_to_the_kernel_only():
    """CPU tensors run the plain version and count no launch; the kernel's
    wrapper refuses CPU tensors (no fallback)."""
    x = torch.arange(10, dtype=torch.float32).reshape(2, 5)
    launches = ROW_SCAN.launches
    assert torch.equal(basic.fast_cumsum(x), torch.cumsum(x, dim=-1))
    with pytest.raises(ValueError, match="CUDA"):
        ROW_SCAN.run("sum", (x,))
    with pytest.raises(ValueError, match="CUDA"):
        ROW_SCAN.fill((x,), x > 3)
    assert ROW_SCAN.launches == launches
