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
tolerances.

K4 itself runs here in its host build (g++, the kernel's phases over
arrays, its ring's copies as memcpy): the kernel's 16-byte and
one-element variants (entries ``*_vec`` and ``*``) equal each other bit
for bit for every kind and dtype at row lengths around the chunk and the
ring, and the plain versions (exact for the integer kinds, maxes and
fills, bit for bit for sums and affine scans of exactly representable
values, within the tolerances above for random f32 and ``1e-12`` for
random f64); a mocked launch shows which variant and build the wrapper
picks.  ``test_torch_block_host.py`` and
``test_torch_exact_host.py`` hold more of the host build.
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

from srack_tpu_torch.ops import basic, scan_kernel
from srack_tpu_torch.ops.cuda_lib import build
from srack_tpu_torch.ops.scan_kernel import ROW_SCAN, ROW_SCAN_F64

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


# -- K4's host build: both variants against each other and the plain versions

HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
              "-shared", "-fPIC")
P, I = ctypes.c_void_p, ctypes.c_int
F32, I32, F64 = torch.float32, torch.int32, torch.float64
DT = {F32: "f32", I32: "i32", F64: "f64"}
# around the 1,024-element chunk, a partial last chunk, more chunks than
# the ring's stages (4 at most); 1,024, 4,100 and 9,000 fit the 16-byte
# variant for every dtype
HOST_NS = (1, 3, 1023, 1024, 1025, 4099, 4100, 9000)
HOST_CASES = ([(kind, dt, 0) for kind in ("sum", "max")
               for dt in (F32, I32, F64)]
              + [("fill", dt, k) for dt in (F32, I32, F64)
                 for k in (1, 2, 3, 4)]
              + [("affine", F32, 0)])
ROWS = 3


@pytest.fixture(scope="module")
def k4_host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ unavailable")
    path, _ = build(ROW_SCAN.source, compiler=gxx, flags=HOST_FLAGS,
                    root=tmp_path_factory.mktemp("k4"))
    return ctypes.CDLL(str(path))


def _values(dtype, shape, rng, exact):
    """Random rows; ``exact``: small integers, whose sums every order of
    combination gives alike."""
    if exact:
        return torch.from_numpy(rng.integers(-100, 101, shape)).to(dtype)
    if dtype == I32:
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, shape,
                                             dtype=np.int64).astype(np.int32))
    return torch.from_numpy(rng.standard_normal(shape)).to(dtype)


def _host_inputs(kind, dtype, k, n, seed, exact):
    rng = np.random.default_rng(seed)
    if kind == "fill":
        mask = torch.from_numpy(rng.uniform(size=(ROWS, n)) < 0.01)
        mask[1] = False                     # a row that never fills
        mask[2, :min(n, 5)] = True
        return (_values(dtype, (k, ROWS, n), rng, exact), mask)
    if kind == "affine":
        sign = rng.integers(0, 2, (ROWS, n)) * 2 - 1
        a = (torch.from_numpy(sign).to(F32) if exact else torch.from_numpy(
            rng.uniform(0.9, 1.0, (ROWS, n))).to(F32))
        return (a, _values(F32, (ROWS, n), rng, exact))
    return (_values(dtype, (ROWS, n), rng, exact),)


def _host_scan(lib, entry, kind, ins, n):
    """One host entry on ``ins``: ``(return code, outputs)``."""
    fn = getattr(lib, entry)
    fn.restype = I
    if kind == "fill":
        vals, mask = ins
        m = mask.to(I32)
        out, ok = torch.empty_like(vals), torch.empty((ROWS, n), dtype=I32)
        fn.argtypes = [P, P, P, P, I, I, I]
        rc = fn(vals.data_ptr(), m.data_ptr(), out.data_ptr(), ok.data_ptr(),
                vals.shape[0], ROWS, n)
        return rc, (out, ok)
    outs = tuple(torch.empty_like(x) for x in ins)
    fn.argtypes = [P] * (2 * len(ins)) + [I, I]
    rc = fn(*[x.data_ptr() for x in ins + outs], ROWS, n)
    return rc, outs


def _host_plain(kind, ins):
    if kind == "fill":
        filled, ok = basic.forward_fill_multi_plain(tuple(ins[0]), ins[1])
        return torch.stack(filled), ok
    if kind == "affine":
        return basic.affine_scan_plain(*ins)
    return ((basic.cumsum_plain if kind == "sum"
             else basic.cummax_plain)(ins[0]),)


@pytest.mark.parametrize("vec", [False, True])
@pytest.mark.parametrize("n", HOST_NS)
@pytest.mark.parametrize("kind,dtype,k", HOST_CASES)
def test_k4_host_variants_equal_plain(k4_host, kind, dtype, k, n, vec):
    base = f"srk_scan_{kind}_{DT[dtype]}"
    fits = all(n * size % 16 == 0 for size in
               (dtype.itemsize, 4 if kind == "fill" else dtype.itemsize))
    for exact in (False, True):
        ins = _host_inputs(kind, dtype, k, n, n + 7 * k, exact)
        rc, got = _host_scan(k4_host, base + ("_vec" if vec else ""), kind,
                             ins, n)
        if vec and not fits:
            assert rc == -2      # the 16-byte variant refuses such rows
            return
        assert rc == 0
        if vec:          # the same kernel as the one-element variant
            rc, one = _host_scan(k4_host, base, kind, ins, n)
            assert rc == 0
            for g, w in zip(got, one):
                assert torch.equal(g, w)
        want = _host_plain(kind, ins)
        if kind == "fill":
            ok = want[1]
            assert torch.equal(got[1] != 0, ok)
            for j in range(k):
                assert torch.equal(got[0][j][ok], want[0][j][ok])
        elif exact or kind == "max" or dtype == I32:
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        else:
            tol = 1e-12 if dtype == F64 else TOL[f"{kind}_f32"]
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=tol, atol=tol)


def test_wrapper_picks_the_variant_by_row_alignment(monkeypatch):
    """On CUDA tensors (the wrapper asked; no card needed) rows that start
    on 16 bytes in every array take the 16-byte variant, other rows the
    one-element variant; f64 arrays go to the f64 build."""
    calls = []
    for lib in (ROW_SCAN, ROW_SCAN_F64):
        monkeypatch.setattr(lib, "launch",
                            lambda entry, *a, lib=lib: calls.append(
                                (lib.name, entry)))
    monkeypatch.setattr(scan_kernel, "require_cuda",
                        lambda *t: torch.device("cpu"))
    x = torch.zeros((2, 48))
    off = torch.zeros(2 * 48 + 1)[1:].view(2, 48)  # rows 4 bytes off
    ROW_SCAN.run("sum", (x,))
    ROW_SCAN.run("sum", (x[:, :47],))              # 47 floats a row
    ROW_SCAN.run("max", (off,))
    ROW_SCAN.run("sum", (x.to(I32),))
    ROW_SCAN.run("affine", (x, x))
    ROW_SCAN.fill((x, x.to(F64)), x > 0)
    ROW_SCAN.fill((x[:, :46].to(F64),), x[:, :46] > 0)  # the mask's rows
    ROW_SCAN_F64.run("sum", (x[:, :46].to(F64),))        # 46 doubles fit
    assert calls == [
        ("row_scan", "srk_scan_sum_f32_vec"),
        ("row_scan", "srk_scan_sum_f32"),
        ("row_scan", "srk_scan_max_f32"),
        ("row_scan", "srk_scan_sum_i32_vec"),
        ("row_scan", "srk_scan_affine_f32_vec"),
        ("row_scan", "srk_scan_fill_f32_vec"),
        ("row_scan_f64", "srk_scan_fill_f64_vec"),
        ("row_scan_f64", "srk_scan_fill_f64"),
        ("row_scan_f64", "srk_scan_sum_f64_vec")]
