"""The f64 builds of kernels K3, K4, K8 and K9 on the host (g++), each held
against its plain version.

The card is not here, so the kernels' sources build with g++ (``-x c++
-ffp-contract=off``: a*b+c rounds twice, as nvcc's ``--fmad=false``
build does) into their host entries, which run the card's schedule in
loops over the same functions:

* **K3's f64 build** (``serial_stage_f64``): the exact stage of
  feedback_patch, whose two Oscillators run inside the stage with their
  f64 phase in the kernel's double rows, split into its pipeline stages
  (the host runs their lock step) and as one thread, at n = 1,024 and
  1,023 from random phases; and the exact subtractive_voice stage (Moog,
  ADSR: no f64 leaf, the f32 build).  Against ``stage_plain``, the torch
  loop: audio within 1e-6, f64 state within 1e-12, int32 and bool state
  equal.
* **K4's f64 entries**: ``srk_scan_sum_f64`` within 1e-12 relative of the
  log-doubling sum, ``srk_scan_max_f64`` and ``srk_scan_fill_f64`` exact,
  in both variants and in the one-element variant on arrays whose base
  pointers lie 8 bytes off 16 (which the 16-byte variant refuses).
* **K8's f64 build**: ``srk_freeverb_f64`` (the shared-memory schedule)
  and ``srk_freeverb_twin_f64`` within 2e-5 (abs + rel) of the f64
  ``block_plain``, at 4,800 Hz and 48 kHz, and equal to each other bit for
  bit; the f64 rule on line lengths.
* **K9's f64 build**: ``srk_ring_align_tile_f64`` exact against the plain
  gather, both directions and rings to rings.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import srack_tpu_torch as stt
from srack_tpu_torch.block_engine import wire_key
from srack_tpu_torch.compiler import tree_map
from srack_tpu_torch.modules import freeverb as fv
from srack_tpu_torch.ops import basic, freeverb_kernel as fvk, fused
from srack_tpu_torch.ops.cuda_lib import build
from srack_tpu_torch.ops.ring_roll import (RING_ALIGN_F64, ring_align_for,
                                          ring_align_plain)
from srack_tpu_torch.ops.scan_kernel import ROW_SCAN_F64

from test_torch_block_host import _at, _k4_call

HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
              "-shared", "-fPIC")
SR = 4800
F64 = torch.float64
P, I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def gxx():
    path = shutil.which("g++")
    if path is None:
        pytest.skip("g++ unavailable")
    return path


def _lib(source, gxx, root):
    return ctypes.CDLL(str(build(source, compiler=gxx, flags=HOST_FLAGS,
                                 root=root)[0]))


def _fn(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = I
    return fn


# -- K3 ----------------------------------------------------------------------

@pytest.mark.parametrize("stages", [4, 1])
@pytest.mark.parametrize("n", [1024, 1023])
@pytest.mark.parametrize("name", ["feedback_patch", "subtractive_voice"])
def test_exact_stage_on_host_matches_stage_loop(gxx, tmp_path, name, n,
                                                stages):
    patch = getattr(stt.presets, name)(stt.AudioConfig(
        sample_rate=SR, channels=1, precision="exact"))
    compiled = stt.compile_patch(patch)
    prog = compiled.block_program()
    assert prog.kernel_ok
    v = 5
    params = stt.presets.farm_params(patch, v, seed=n)
    state = tree_map(lambda a: a.expand((v,) + a.shape).contiguous(),
                     compiled.init_state())
    rng = np.random.default_rng(n + stages)
    for mid, (mdef, _, _) in compiled.instances.items():
        if mdef.type_name == "Oscillator":
            state["states"][mid]["pos"] = torch.from_numpy(
                rng.uniform(0.0, 1.0, v))
    lanes = {wire_key(w): torch.from_numpy(
        rng.uniform(-1, 1, (v, n)).astype(np.float32))
        for w in prog.stage_in}
    kernel = fused.StageKernel(prog, lanes, stages=stages)
    doubles = name == "feedback_patch"   # its Oscillators are in the stage
    assert kernel.layout.doubles == doubles
    assert kernel.name == ("serial_stage_f64" if doubles
                           else "serial_stage")
    if stages > 1:
        assert kernel.partition.n_stages == 2 and kernel.chunk == 32
    fn = _fn(_lib(kernel.source, gxx, tmp_path), "srk_fused_host",
             fused.ARGTYPES_F64 if doubles else fused.ARGTYPES)
    stage_state = {"states": {m: state["states"][m] for m in prog.stage_plan},
                   "fb": state["fb"]}
    pf, pi, sf, si, lanes_p, ring, _, pd, sd = kernel.operands(
        params, stage_state, n, lanes)
    outs = torch.full((max(len(prog.stage_out), 1), n, v), float("nan"))
    sf_out, si_out = torch.empty_like(sf), torch.empty_like(si)
    args = [pf, pi, sf, si, lanes_p, ring, outs, sf_out, si_out]
    sd_out = None
    if doubles:
        assert pd.dtype == F64 and sd.dtype == F64
        sd_out = torch.empty_like(sd)
        args += [pd, sd, sd_out]
    assert fn(*[a.data_ptr() for a in args], v, n) == 0
    final = kernel.finish(sf_out, si_out, ring, v, sd_out)
    derived = compiled.derived_params(params)
    want, want_final = prog.stage_plain(
        {m: derived[m] for m in prog.stage_plan}, stage_state, lanes, n)
    for j, w in enumerate(prog.stage_out):
        torch.testing.assert_close(outs[j].T, want[w], atol=1e-6, rtol=0)
    for mid in prog.stage_plan:
        for key, wv in want_final["states"][mid].items():
            g = final["states"][mid][key]
            assert g.dtype == wv.dtype, (mid, key)
            if wv.dtype in (torch.int32, torch.bool):
                assert torch.equal(g, wv), (mid, key)
            else:
                torch.testing.assert_close(
                    g, wv, atol=1e-12 if wv.dtype == F64 else 1e-6, rtol=0)
    for k, wv in want_final["fb"].items():
        torch.testing.assert_close(final["fb"][k], wv, atol=1e-6, rtol=0)
    assert kernel.launches == 0


def test_exact_oscillator_device_function_is_picked_by_its_leaves():
    """The exact Oscillator's call passes a double phase (and a double
    increment when hoisted): the overloads of ``srk_oscillator`` in
    ``csrc/modules.cuh`` that take ``double&``."""
    patch = stt.presets.feedback_patch(stt.AudioConfig(
        sample_rate=SR, channels=1, precision="exact"))
    prog = stt.compile_patch(patch).block_program()
    kernel = fused.StageKernel(prog, {})
    src = kernel.source
    assert "double s_" in src and "const double* pd" in src
    assert "srk_oscillator<" in src
    with pytest.raises(ValueError, match="fast precision"):
        fused.generate_source(stt.compile_patch(patch), mode="ckpt")


# -- K4 ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def k4_f64(gxx, tmp_path_factory):
    """K4's host build (its f64 entries), once for the module."""
    return _lib(ROW_SCAN_F64.source, gxx, tmp_path_factory.mktemp("k4"))


# K4's entry forms: the one-element variant, the 16-byte one (rows of an
# even number of doubles; a fill's int32 mask asks a multiple of 4), and
# the one-element variant on arrays one element into a larger buffer
@pytest.mark.parametrize("form", ["", "_vec", "_off"])
@pytest.mark.parametrize("n", [1, 1000, 2500])
@pytest.mark.parametrize("kind", ["sum", "max"])
def test_row_scan_f64_on_host_matches_plain(k4_f64, kind, n, form):
    rng = np.random.default_rng(n)
    x = _at(form, torch.from_numpy(rng.uniform(0.0, 0.1, (3, n))))
    y = _at(form, torch.empty_like(x))
    rc = _k4_call(k4_f64, f"srk_scan_{kind}_f64", [P, P, I, I], form,
                  x.data_ptr(), y.data_ptr(), 3, n)
    if form == "_vec" and n % 2:
        assert rc == -2
        return
    assert rc == 0
    want = (basic.cumsum_plain if kind == "sum" else basic.cummax_plain)(x)
    if kind == "max":
        assert torch.equal(y, want)
    else:
        torch.testing.assert_close(y, want, rtol=1e-12, atol=0)
    assert ROW_SCAN_F64.launches == 0


@pytest.mark.parametrize("form", ["", "_vec", "_off"])
@pytest.mark.parametrize("k", [1, 3])
def test_row_fill_f64_on_host_matches_plain(k4_f64, k, form):
    rng = np.random.default_rng(k)
    n = 2300
    vals = _at(form, torch.from_numpy(rng.standard_normal((k, 3, n))))
    mask = torch.from_numpy(rng.uniform(size=(3, n)) < 0.01)
    mask[1] = False
    mask[2, 1500:] = False
    out = _at(form, torch.empty_like(vals))
    ok = _at(form, torch.empty((3, n), dtype=torch.int32))
    m = _at(form, mask.to(torch.int32))
    assert _k4_call(k4_f64, "srk_scan_fill_f64", [P, P, P, P, I, I, I], form,
                    vals.data_ptr(), m.data_ptr(), out.data_ptr(),
                    ok.data_ptr(), k, 3, n) == 0
    want, want_ok = basic.forward_fill_multi_plain(tuple(vals), mask)
    assert torch.equal(ok != 0, want_ok)
    for j in range(k):
        assert torch.equal(out[j][want_ok], want[j][want_ok])


def test_f64_rows_route_to_the_f64_build(monkeypatch):
    """On CUDA tensors an f64 cumsum or fill goes to K4's f64 build (the
    wrapper is asked; no card needed), f32 and int32 to the other, each to
    its 16-byte variant (rows of 8 elements); on CPU tensors the plain
    versions run."""
    calls = []
    for lib in (ROW_SCAN_F64, basic._k4()):
        monkeypatch.setattr(lib, "launch",
                            lambda entry, *a, lib=lib: calls.append(
                                (lib.name, entry)))
    monkeypatch.setattr("srack_tpu_torch.ops.scan_kernel.require_cuda",
                        lambda *t: torch.device("cpu"))
    x = torch.zeros((2, 8), dtype=F64)
    basic._k4(F64).run("sum", (x,))
    basic._k4().fill((x, x.float()), x > 0)
    assert calls == [("row_scan_f64", "srk_scan_sum_f64_vec"),
                     ("row_scan_f64", "srk_scan_fill_f64_vec"),
                     ("row_scan", "srk_scan_fill_f32_vec")]
    with pytest.raises(TypeError, match="row_scan_f64"):
        ROW_SCAN_F64.run("sum", (x.float(),))
    assert basic.fast_cumsum(x).dtype == F64


# -- K8 ----------------------------------------------------------------------

def _fv_inputs(v, n, seed, sr):
    cfg = stt.AudioConfig(sample_rate=sr, channels=2, precision="exact")
    rng = np.random.default_rng(seed)
    state = {}
    for k, length in zip(fv.LINE_KEYS, fvk.all_lengths(cfg)):
        state[k] = torch.from_numpy(rng.standard_normal((v, length)) * 0.1)
        state[f"{k}_idx"] = torch.from_numpy(
            rng.integers(0, length, v).astype(np.int32))
    for k in fv.FS_KEYS:
        state[k] = torch.from_numpy(rng.standard_normal(v) * 0.1)
    _, p0 = fv.FREEVERB.make(cfg, room_size=0.7, dampening=0.4, wet=0.3,
                             dry=0.2)
    params = {k: a.expand(v).clone() for k, a in p0.items()}
    params["room_size"] = torch.from_numpy(
        rng.uniform(0.3, 0.9, (v, n)).astype(np.float32))
    params["wet"] = torch.from_numpy(
        rng.uniform(0.1, 0.5, (v, n)).astype(np.float32))
    l_in = torch.from_numpy((rng.standard_normal((v, n)) * 0.3)
                            .astype(np.float32))
    r_in = torch.from_numpy((rng.standard_normal((v, n)) * 0.3)
                            .astype(np.float32))
    return cfg, params, state, l_in, r_in


def _k8_host(lib, kernel, cfg, l_in, r_in, gains, state, n):
    lens = fvk.all_lengths(cfg)
    lines = torch.cat([ring_align_plain(state[k], state[f"{k}_idx"]).T
                       for k in fv.LINE_KEYS]).contiguous()
    fs = torch.stack([state[k] for k in fv.FS_KEYS], dim=1).contiguous()
    args, argtypes, _keep, out_l, out_r = kernel.entry_args(
        cfg, l_in, r_in, gains, fs, lines, n, False,
        fvk.line_tables(lens, "cpu"))
    assert _fn(lib, kernel.entry, argtypes)(*args) == 0
    assert kernel.launches == 0
    return out_l, out_r, fs, lines


@pytest.mark.parametrize("sr,n", [(4800, 480), (4800, 500), (48000, 600)])
def test_freeverb_f64_on_host_matches_block_form(gxx, tmp_path, sr, n):
    """Both f64 entries within 2e-5 (abs + rel) of the f64 block form,
    and equal to each other bit for bit; lines and filter states stay
    f64, the audio f32."""
    v = 2
    cfg, params, state, l_in, r_in = _fv_inputs(v, n, n + sr, sr)
    gains = fv.block_gains(params, v, F64)
    assert all(g.dtype == F64 for g in gains)
    want_state, (want_l, want_r) = fv.block_plain(l_in, r_in, gains,
                                                  state, n)
    assert want_l.dtype == torch.float32
    assert want_state["cl0"].dtype == F64
    lens = fvk.all_lengths(cfg)
    assert fvk.kernel_for(lens, F64) is fvk.FREEVERB_F64
    lib = _lib(fvk.FREEVERB_F64.source, gxx, tmp_path)
    got = _k8_host(lib, fvk.FREEVERB_F64, cfg, l_in, r_in, gains, state, n)
    twin = _k8_host(lib, fvk.FREEVERB_TWIN_F64, cfg, l_in, r_in, gains,
                    state, n)
    for g, w in zip(got, twin):
        assert g.dtype == w.dtype and torch.equal(g, w)
    out_l, out_r, fs, lines = got
    assert out_l.dtype == torch.float32 and lines.dtype == F64
    for g, w in ((out_l, want_l), (out_r, want_r)):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-5)
        # in f64 the chunked form's reassociation stays below the f32
        # output's rounding: the outputs differ by at most two f32 ulps
        assert ((g - w).abs() <= 2.4e-7 * w.abs().clamp(min=1.0)).all()
    for j, k in enumerate(fv.FS_KEYS):
        torch.testing.assert_close(fs[:, j], want_state[k], atol=2e-5,
                                   rtol=2e-5)
    for k, rows, length in zip(fv.LINE_KEYS, torch.split(lines, list(lens)),
                               lens):
        back = ring_align_plain(rows.T, torch.full((v,), n % length,
                                                 dtype=torch.int32))
        torch.testing.assert_close(back, want_state[k], atol=2e-5, rtol=2e-5)


def test_freeverb_f64_rule_on_line_lengths():
    """8-byte lines: at 48 kHz 8 * (27,688 + 256) = 223,552 B, one CTA's
    worth; at 96 kHz they do not fit and the f64 twin runs (a rule on the
    line lengths, never a fallback on error); below 1,568 Hz the shortest
    allpass decides as for f32."""
    want = {4800: (24, fvk.FREEVERB_F64), 48000: (128, fvk.FREEVERB_F64),
            96000: (None, fvk.FREEVERB_TWIN_F64),
            1000: (None, fvk.FREEVERB_TWIN_F64)}
    for sr, (t, kernel) in want.items():
        lens = fvk.all_lengths(stt.AudioConfig(sample_rate=sr))
        assert fvk.tile_for(lens, 8) == t, sr
        assert fvk.kernel_for(lens, F64) is kernel, sr
        assert fvk.kernel_for(lens) in (fvk.FREEVERB, fvk.FREEVERB_TWIN)
    lens = fvk.all_lengths(stt.AudioConfig(sample_rate=48000))
    assert fvk.tile_bytes(lens, 128, 8) == 223552 <= fvk.SMEM_MAX
    assert fvk.FREEVERB_F64.entry == "srk_freeverb_f64"
    assert fvk.FREEVERB_TWIN_F64.entry == "srk_freeverb_twin_f64"
    assert fvk.FREEVERB_F64.source == fvk.FREEVERB.source


# -- K9 ----------------------------------------------------------------------

def _k9_host(lib, src, dst, lens, v, idx, shifts, src_lines, dst_lines):
    n = len(lens)
    return _fn(lib, "srk_ring_align_tile_f64", [P, P, P, P, P, I, I, I, I,
                                                I])(
        (P * n)(*[t.data_ptr() for t in src]),
        (P * n)(*[t.data_ptr() for t in dst]), (I * n)(*lens),
        (I * n)(*shifts), None if idx is None else idx.data_ptr(), n, v,
        int(src_lines), int(dst_lines), RING_ALIGN_F64.tile)


@pytest.mark.parametrize("src_lines,dst_lines",
                         [(False, False), (False, True), (True, False)])
def test_ring_align_f64_on_host_matches_plain(gxx, tmp_path, src_lines,
                                              dst_lines):
    """The f64 tile, rings to rings, rings to lines and back, with
    per-voice indices and per-line shifts, on 33 voices (two voice tiles)
    and lines 1-300 long: exact, doubles moved whole (no voice's word on
    another voice's row)."""
    rng = np.random.default_rng(1)
    lens, v = (5, 300, 129, 1, 128), 33
    rings = [torch.from_numpy(rng.standard_normal((v, n))) for n in lens]
    idx = torch.from_numpy(rng.integers(-300, 300, (len(lens), v))
                           .astype(np.int32))
    shifts = [int(s) for s in rng.integers(0, 1000, len(lens))]
    src = [r.T.contiguous() if src_lines else r for r in rings]
    lib = _lib(RING_ALIGN_F64.source, gxx, tmp_path)
    dst = [torch.empty((n, v) if dst_lines else (v, n), dtype=F64)
           for n in lens]
    assert _k9_host(lib, src, dst, lens, v, idx, shifts, src_lines,
                    dst_lines) == 0
    for j, (d, r, n) in enumerate(zip(dst, rings, lens)):
        want = ring_align_plain(r, (idx[j] + shifts[j]) % n)
        assert torch.equal(d.T if dst_lines else d, want), j
    assert RING_ALIGN_F64.launches == 0


def test_ring_align_f64_wrappers():
    """The f64 build takes f64 lines only, names its entry, and is the
    main path's K9 for f64 lines."""
    assert ring_align_for(F64) is RING_ALIGN_F64
    assert RING_ALIGN_F64.name == "ring_align_f64"
    src, dst = [torch.zeros((2, 5))], [torch.zeros((2, 5))]
    with pytest.raises(ValueError, match="float32"):
        RING_ALIGN_F64.call(src, dst, (5,), 2)
    assert 'extern "C" int srk_ring_align_tile_f64(' in RING_ALIGN_F64.source
