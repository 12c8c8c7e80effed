"""The block engine's CUDA sources, checked on the CPU.

Each kernel source has a host build (g++, ``-ffp-contract=off``) that runs
the very per-voice or per-row body the card runs, in a loop.  Here each is
held against its plain version on the same inputs:

* K3, the serial stage (``ops/fused.py`` in stage mode), for the stages of
  ``reverb_patch``, ``block_check_patch`` (an input wire),
  ``feedback_patch`` (feedback carries inside the stage), the same in
  buffer mode (the feedback read from the previous block's lanes) and
  ``kit_check_patch`` (two input wires): bit-exact against
  ``BlockProgram.stage_plain`` (output lanes and state);
* K4, the row scans (``csrc/row_scan.cu``), each entry in three forms
  (the one-element and 16-byte variants, and the one-element variant on
  arrays whose base pointers lie 4 bytes off 16): int32 sum, max and fill
  exact against the log-doubling plain versions, f32 sum within ``2e-4``
  and affine within ``3e-4`` (``tests/test_scan_kernel.py``'s
  tolerances: both reassociate), rows longer than one chunk so the carried
  prefix is used; the 16-byte variant refuses rows it does not fit, by
  length or by pointer;
* K9, the ring alignment (``csrc/ring_align.cu``), rings to rings and
  to and from the Freeverb kernel's ``[L, V]`` lines: exact;
* K8, the Freeverb (``csrc/freeverb.cu``) with the wrapper's layout around
  it, both entries: the shared-memory kernel bit for bit equal to its
  one-thread twin (audio, filter states, lines) and both within ``2e-5``
  of the chunked block form, from rings with non-zero write indices, with
  and without automated ``room_size`` and ``wet`` lanes, at 48 kHz and
  4,800 Hz (shortest line 24), n a multiple of the chunk, not one, and
  shorter than one; input lanes read in place through their strides (K3's
  time-major layout, broadcasts, mono), f32 and f64, bit for bit those of
  contiguous copies, and the wrapper's operands and lane counters; the
  rule that picks the twin (lines too long for shared memory) and that an
  error never does;
* K5/K6, the row gather (``csrc/row_gather.cu``), both entries, f32 and
  int32 tables, indices in and out of range: exact against the plain
  gather;
* K7, the Sample player (``csrc/sample_play.cu``, its main path's entry
  ``srk_sample_play`` on ``[R, n]`` rows): bit-exact against its
  unfused form run with the host build of K4 for its two scans -- the
  check that K7 combines in K4's order, at base 0.937 where the order
  shows -- and exact against the plain version (log-doubling scans) at
  representable rates; CV connected and not, rows of several chunks.

The main path never uses these host builds.
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
from srack_tpu_torch.modules import sample as smp
from srack_tpu_torch.ops import basic, freeverb_kernel as fvk, fused
from srack_tpu_torch.ops.cuda_lib import build
from srack_tpu_torch.ops.freeverb_kernel import FREEVERB
from srack_tpu_torch.ops.ring_roll import RING_ALIGN, ring_align_plain
from srack_tpu_torch.ops.gather_kernel import ROW_GATHER, ROW_GATHER_LONG
from srack_tpu_torch.ops.sample_kernel import SAMPLE_PLAY
from srack_tpu_torch.ops.scan_kernel import ROW_SCAN

HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
              "-shared", "-fPIC")
SR = 4800
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@pytest.fixture(scope="module")
def gxx():
    path = shutil.which("g++")
    if path is None:
        pytest.skip("g++ unavailable")
    return path


def _host(lib, gxx, root):
    path, _ = build(lib.source, compiler=gxx, flags=HOST_FLAGS, root=root)
    return ctypes.CDLL(str(path))


@pytest.fixture(scope="module")
def k4_lib(gxx, tmp_path_factory):
    """K4's host build, once for the module."""
    return _host(ROW_SCAN, gxx, tmp_path_factory.mktemp("k4"))


# K4's entry forms: the one-element variant, the 16-byte one, and the
# one-element variant on arrays one element into a larger buffer
FORMS = ("", "_vec", "_off")


def _fits(form, n, *sizes):
    """Whether entry form ``form`` takes rows of ``n`` elements of these
    sizes (the 16-byte variant: each row a multiple of 16 bytes)."""
    return form != "_vec" or all(n * s % 16 == 0 for s in sizes)


def _fn(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = I
    return fn


def _at(form, t):
    """``t`` as entry form ``form`` takes it: for ``_off`` a copy viewed
    one element into a larger buffer, so its base pointer is 4 or 8 bytes
    off 16."""
    if form != "_off":
        return t
    off = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    assert off.data_ptr() % 16
    return off.copy_(t)


def _k4_call(lib, name, argtypes, form, *args):
    """K4's entry ``name`` in ``form`` on ``args``: ``_off`` runs the
    one-element variant after the 16-byte one refused the same views."""
    if form == "_off":
        assert _fn(lib, name + "_vec", argtypes)(*args) == -2
        form = ""
    return _fn(lib, name + form, argtypes)(*args)


# -- K3 ----------------------------------------------------------------------

def _stage_case(name):
    if name == "reverb_patch":
        patch = stt.presets.reverb_patch(stt.AudioConfig(sample_rate=SR,
                                                         channels=2))
        return patch, stt.compile_patch(patch)
    if name in ("feedback_patch", "feedback_buffer"):
        patch = stt.presets.feedback_patch(stt.AudioConfig(
            sample_rate=SR, block_size=64, channels=1,
            buffer_feedback=name == "feedback_buffer"))
        return patch, stt.compile_patch(patch)
    if name == "kit_check_patch":
        patch = stt.presets.kit_check_patch(stt.AudioConfig(sample_rate=SR,
                                                            channels=1))
        return patch, stt.compile_patch(patch)
    patch, autos = stt.presets.block_check_patch(
        stt.AudioConfig(sample_rate=SR, channels=1))
    return patch, stt.compile_patch(patch, automation=autos)


@pytest.mark.parametrize("n", [256, 255])
@pytest.mark.parametrize("name", ["reverb_patch", "block_check_patch",
                                  "feedback_patch", "feedback_buffer",
                                  "kit_check_patch"])
def test_stage_kernel_on_host_matches_stage_loop(gxx, tmp_path, name, n):
    patch, compiled = _stage_case(name)
    prog = compiled.block_program()
    v = 5
    params = stt.presets.farm_params(patch, v, seed=n)
    state = tree_map(lambda a: a.expand((v,) + a.shape).contiguous(),
                     compiled.init_state())
    rng = np.random.default_rng(n)
    # the stage's input wires as random lanes (the Freeverb's Left for the
    # block check patch; reverb_patch's stage has none), in buffer mode
    # also the previous block's feedback lanes
    lanes = {wire_key(w): torch.from_numpy(
        rng.uniform(-1, 1, (v, n)).astype(np.float32))
        for w in prog.stage_in + [("fb",) + k for k in prog.stage_fb_in]}
    assert bool(prog.stage_fb_in) == (name == "feedback_buffer")
    kernel = prog.stage_kernel(lanes)
    assert kernel.name == "serial_stage"
    lib = _fn(ctypes.CDLL(str(build(kernel.source, compiler=gxx,
                                    flags=HOST_FLAGS, root=tmp_path)[0])),
              "srk_fused_host", fused.ARGTYPES)
    stage_state = {"states": {m: state["states"][m] for m in prog.stage_plan},
                   "fb": {} if prog.buffer_mode else state["fb"]}
    pf, pi, sf, si, lanes_p, ring, _ = kernel.pack(params, stage_state, n,
                                                   lanes)
    outs = torch.empty((max(len(prog.stage_out), 1), n, v))
    sf_out, si_out = torch.empty_like(sf), torch.empty_like(si)
    assert lib(pf.data_ptr(), pi.data_ptr(), sf.data_ptr(), si.data_ptr(),
               lanes_p.data_ptr(), ring.data_ptr(), outs.data_ptr(),
               sf_out.data_ptr(), si_out.data_ptr(), v, n) == 0
    final = kernel.finish(sf_out, si_out, ring, v)
    derived = compiled.derived_params(params)
    want, want_final = prog.stage_plain(
        {m: derived[m] for m in prog.stage_plan}, stage_state, lanes, n)
    assert prog.stage_out
    for j, w in enumerate(prog.stage_out):
        assert torch.equal(outs[j].T, want[w]), w
    for mid in prog.stage_plan:
        for key, wv in want_final["states"][mid].items():
            assert torch.equal(final["states"][mid][key], wv), (mid, key)
    assert set(final["fb"]) == set(want_final["fb"])
    for k, wv in want_final["fb"].items():
        assert torch.equal(final["fb"][k], wv), k
    assert kernel.launches == 0


# -- K4 ----------------------------------------------------------------------

def _rows(dtype, shape, rng):
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, shape,
                                             dtype=np.int64)
                                .astype(np.int32))
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n", [1, 1000, 2500])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("kind", ["sum", "max"])
def test_row_scan_on_host_matches_plain(k4_lib, kind, dtype, n, form):
    rng = np.random.default_rng(n)
    x = _at(form, _rows(dtype, (3, n), rng))
    dt = "f32" if dtype == torch.float32 else "i32"
    y = _at(form, torch.empty_like(x))
    rc = _k4_call(k4_lib, f"srk_scan_{kind}_{dt}", [P, P, I, I], form,
                  x.data_ptr(), y.data_ptr(), 3, n)
    if not _fits(form, n, 4):
        assert rc == -2
        return
    assert rc == 0
    want = (basic.cumsum_plain if kind == "sum" else basic.cummax_plain)(x)
    if dtype == torch.int32 or kind == "max":
        assert torch.equal(y, want)
    else:
        torch.testing.assert_close(y, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_row_fill_on_host_matches_plain(k4_lib, dtype, k, form):
    rng = np.random.default_rng(k)
    n = 2300
    vals = _at(form, _rows(dtype, (k, 3, n), rng))
    mask = torch.from_numpy(rng.uniform(size=(3, n)) < 0.01)
    mask[1] = False          # a row that never fills
    mask[2, 1500:] = False   # a fill held across chunks
    dt = "f32" if dtype == torch.float32 else "i32"
    out = _at(form, torch.empty_like(vals))
    ok = _at(form, torch.empty((3, n), dtype=torch.int32))
    m = _at(form, mask.to(torch.int32))
    assert _k4_call(k4_lib, f"srk_scan_fill_{dt}", [P, P, P, P, I, I, I],
                    form, vals.data_ptr(), m.data_ptr(), out.data_ptr(),
                    ok.data_ptr(), k, 3, n) == 0
    want, want_ok = basic.forward_fill_multi_plain(tuple(vals), mask)
    assert torch.equal(ok != 0, want_ok)
    for j in range(k):
        # where nothing held yet the value is unspecified
        assert torch.equal(out[j][want_ok], want[j][want_ok])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n", [7, 2500])
def test_row_affine_on_host_matches_plain(k4_lib, n, form):
    rng = np.random.default_rng(n)
    a = _at(form, torch.from_numpy(rng.uniform(0.9, 1.0, (3, n)).astype(
        np.float32)))
    b = _at(form, torch.from_numpy(rng.standard_normal((3, n)).astype(
        np.float32)))
    out_a = _at(form, torch.empty_like(a))
    out_b = _at(form, torch.empty_like(b))
    rc = _k4_call(k4_lib, "srk_scan_affine_f32", [P, P, P, P, I, I], form,
                  a.data_ptr(), b.data_ptr(), out_a.data_ptr(),
                  out_b.data_ptr(), 3, n)
    if not _fits(form, n, 4):
        assert rc == -2
        return
    assert rc == 0
    want_a, want_b = basic.affine_scan_plain(a, b)
    torch.testing.assert_close(out_a, want_a, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(out_b, want_b, rtol=3e-4, atol=3e-4)


# -- K9 ----------------------------------------------------------------------

def _ring_align_host(lib, src, dst, lens, v, idx, shifts, src_lines,
                     dst_lines):
    """The host entry of K9's main-path kernel (the tile) with the
    wrapper's arguments and tile length."""
    n = len(lens)
    return _fn(lib, "srk_ring_align_tile", [P, P, P, P, P, I, I, I, I, I])(
        (P * n)(*[t.data_ptr() for t in src]),
        (P * n)(*[t.data_ptr() for t in dst]), (I * n)(*lens),
        (I * n)(*shifts), None if idx is None else idx.data_ptr(), n, v,
        int(src_lines), int(dst_lines), RING_ALIGN.tile)


@pytest.mark.parametrize("src_lines,dst_lines",
                         [(False, False), (False, True), (True, False)])
def test_ring_align_on_host_matches_plain(gxx, tmp_path, src_lines,
                                          dst_lines):
    """Rings to rings, rings to the Freeverb kernel's ``[L, V]`` lines (the
    wrapper's entry) and back (its exit), with per-voice indices and a
    per-line shift: exact."""
    rng = np.random.default_rng(0)
    lens, v = (5, 121, 24, 1), 7
    rings = [torch.from_numpy(rng.standard_normal((v, n)).astype(np.float32))
             for n in lens]
    idx = torch.from_numpy(rng.integers(-300, 300, (len(lens), v))
                           .astype(np.int32))
    shifts = [int(s) for s in rng.integers(0, 1000, len(lens))]
    src = [r.T.contiguous() if src_lines else r for r in rings]
    dst = [torch.empty((n, v) if dst_lines else (v, n)) for n in lens]
    lib = _host(RING_ALIGN, gxx, tmp_path)
    assert _ring_align_host(lib, src, dst, lens, v, idx, shifts, src_lines,
                            dst_lines) == 0
    for j, (d, r, n) in enumerate(zip(dst, rings, lens)):
        want = ring_align_plain(r, (idx[j] + shifts[j]) % n)
        assert torch.equal(d.T if dst_lines else d, want), j
    assert _ring_align_host(lib, src, dst, lens, v, None, [0] * len(lens),
                            src_lines, dst_lines) == 0
    for d, r in zip(dst, rings):
        assert torch.equal(d.T if dst_lines else d, r)
    assert RING_ALIGN.launches == 0


# -- K8 ----------------------------------------------------------------------

def _freeverb_inputs(v, n, seed, automated, sr=SR):
    cfg = stt.AudioConfig(sample_rate=sr, channels=2)
    rng = np.random.default_rng(seed)
    state = {}
    for k, length in zip(fv.LINE_KEYS, fvk.all_lengths(cfg)):
        state[k] = torch.from_numpy(
            (rng.standard_normal((v, length)) * 0.1).astype(np.float32))
        state[f"{k}_idx"] = torch.from_numpy(
            rng.integers(0, length, v).astype(np.int32))
    for k in fv.FS_KEYS:
        state[k] = torch.from_numpy(
            (rng.standard_normal(v) * 0.1).astype(np.float32))
    _, p0 = fv.FREEVERB.make(cfg, room_size=0.7, dampening=0.4, wet=0.3,
                             dry=0.2)
    params = {k: a.expand(v).clone() for k, a in p0.items()}
    params["room_size"] = torch.from_numpy(
        rng.uniform(0.3, 0.9, v).astype(np.float32))
    if automated:
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
    """One host run of a K8 entry with the wrapper's steps around it (the
    plain alignment and transpose for K9): ``(out_l, out_r, fs, lines)``,
    the filter states and lines as the kernel leaves them."""
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


def _assert_k8_close(cfg, got, want_state, want_l, want_r, n, v):
    """A host run's outputs against ``block_plain``'s within ``2e-5`` (abs +
    rel), the lines after K9's plain move back into rings."""
    out_l, out_r, fs, lines = got
    lens = fvk.all_lengths(cfg)
    torch.testing.assert_close(out_l, want_l, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(out_r, want_r, atol=2e-5, rtol=2e-5)
    for j, k in enumerate(fv.FS_KEYS):
        torch.testing.assert_close(fs[:, j], want_state[k], atol=2e-5,
                                   rtol=2e-5)
    for k, rows, length in zip(fv.LINE_KEYS, torch.split(lines, list(lens)),
                               lens):
        back = ring_align_plain(rows.T, torch.full((v,), n % length,
                                                 dtype=torch.int32))
        torch.testing.assert_close(back, want_state[k], atol=2e-5, rtol=2e-5)
        assert not want_state[f"{k}_idx"].any()


@pytest.mark.parametrize("automated", [False, True])
@pytest.mark.parametrize("n", [512, 300])
def test_freeverb_kernel_on_host_matches_block_form(gxx, tmp_path, n,
                                                    automated):
    """Both entries of K8 within 2e-5 of the block form, and equal to each
    other bit for bit."""
    v = 3
    cfg, params, state, l_in, r_in = _freeverb_inputs(v, n, n, automated)
    gains = fv.block_gains(params, v)
    want_state, (want_l, want_r) = fv.block_plain(l_in, r_in, gains,
                                                  state, n)
    lib = _host(FREEVERB, gxx, tmp_path)
    got = _k8_host(lib, FREEVERB, cfg, l_in, r_in, gains, state, n)
    twin = _k8_host(lib, fvk.FREEVERB_TWIN, cfg, l_in, r_in, gains, state, n)
    _assert_k8_close(cfg, got, want_state, want_l, want_r, n, v)
    _assert_k8_close(cfg, twin, want_state, want_l, want_r, n, v)
    for g, w in zip(got, twin):
        assert torch.equal(g, w)


@pytest.mark.parametrize("automated", [False, True])
@pytest.mark.parametrize("sr,n", [(48000, 2560), (48000, 2500),
                                  (48000, 100), (4800, 480), (4800, 500),
                                  (4800, 20)])
def test_freeverb_smem_kernel_on_host_is_bit_identical_to_its_twin(
        gxx, tmp_path, sr, n, automated):
    """The shared-memory entry's chunk schedule against the one-thread
    twin: audio, filter states and lines bit for bit, at n a multiple of
    the chunk T (128 at 48 kHz, 24 at 4,800 Hz), not one, and shorter than
    one; both within 2e-5 (abs + rel) of ``block_plain``."""
    v = 3
    cfg, params, state, l_in, r_in = _freeverb_inputs(v, n, n + sr,
                                                      automated, sr)
    lens = fvk.all_lengths(cfg)
    t = fvk.tile_for(lens)
    assert t == {48000: 128, 4800: 24}[sr]
    assert 2 * t <= min(lens[:16]) and t <= min(lens)
    assert (n % t == 0) == (n in (2560, 480)) and (n < t) == (n in (100, 20))
    gains = fv.block_gains(params, v)
    want_state, (want_l, want_r) = fv.block_plain(l_in, r_in, gains,
                                                  state, n)
    lib = _host(FREEVERB, gxx, tmp_path)
    got = _k8_host(lib, FREEVERB, cfg, l_in, r_in, gains, state, n)
    twin = _k8_host(lib, fvk.FREEVERB_TWIN, cfg, l_in, r_in, gains, state, n)
    for g, w in zip(got, twin):
        assert torch.equal(g, w)
    _assert_k8_close(cfg, got, want_state, want_l, want_r, n, v)
    assert (got[0] != 0).any()


@pytest.fixture(scope="module")
def k8_lib(gxx, tmp_path_factory):
    """K8's host build (both cores, both entries), once for the module."""
    return _host(FREEVERB, gxx, tmp_path_factory.mktemp("k8"))


def _time_major(x):
    """``x [V, n]`` as the stage kernel K3 leaves a wire: a ``[V, n]`` view
    of a time-major buffer (strides ``(1, V)``), at an offset into it."""
    v, n = x.shape
    buf = torch.full((n + 5, v), float("nan"))
    buf[3:3 + n] = x.T
    return buf[3:3 + n].T


# input layouts: (l, r) from the seed's lanes, and the lanes K8 reads in
# place with a time stride other than 1
K8_LAYOUTS = {
    "time_major": (lambda l, r: (_time_major(l), _time_major(r)), 2),
    "broadcast": (lambda l, r: (l[:, :1].clone(), r[:, :1].clone()), 2),
    "mixed": (lambda l, r: (_time_major(l), r[:1].clone()), 1),
    "mono": (lambda l, r: (_time_major(l),) * 2, 1),
    "contiguous": (lambda l, r: (l, r), 0),
}


@pytest.mark.parametrize("core", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", list(K8_LAYOUTS))
def test_freeverb_kernel_on_host_reads_lanes_in_place(k8_lib, layout, core):
    """Both K8 entries read their input lanes through the lanes' own
    strides: from K3's time-major layout, a stride-0 broadcast, two lanes
    in different layouts and one mono lane, audio, filter states and lines
    are bit for bit those of the same call on contiguous copies, the
    shared-memory entry's those of its twin, in f32 and in f64; all within
    2e-5 of ``block_plain``.  Each lane of a time stride other than 1 is
    counted in ``strided_lanes``, none copied."""
    v, n = 3, 300
    cfg, params, state, l_in, r_in = _freeverb_inputs(v, n, 7, True)
    if core == torch.float64:
        state = {k: x.to(core) if x.is_floating_point() else x
                 for k, x in state.items()}
    make, strided = K8_LAYOUTS[layout]
    lanes = make(l_in, r_in)
    rows = [x.expand(v, n).contiguous() for x in lanes]
    if lanes[0] is lanes[1]:
        rows[1] = rows[0]
    gains = fv.block_gains(params, v, core)
    want_state, (want_l, want_r) = fv.block_plain(*rows, gains, state, n)
    tiled, twin = ((fvk.FREEVERB, fvk.FREEVERB_TWIN) if core == torch.float32
                   else (fvk.FREEVERB_F64, fvk.FREEVERB_TWIN_F64))
    runs = []
    for kernel in (tiled, twin):
        before = (kernel.strided_lanes, kernel.lane_copies)
        runs.append(_k8_host(k8_lib, kernel, cfg, *lanes, gains, state, n))
        assert (kernel.strided_lanes - before[0],
                kernel.lane_copies - before[1]) == (strided, 0)
        runs.append(_k8_host(k8_lib, kernel, cfg, *rows, gains, state, n))
        assert (kernel.strided_lanes - before[0],
                kernel.lane_copies - before[1]) == (strided, 0)
    for got in runs[1:]:
        for g, w in zip(got, runs[0]):
            assert g.dtype == w.dtype and torch.equal(g, w)
    _assert_k8_close(cfg, runs[0], want_state, want_l, want_r, n, v)
    assert (runs[0][0] != 0).any()


def test_freeverb_wrapper_passes_lanes_without_a_copy(k8_lib, monkeypatch):
    """The wrapper's operands: a lane in K3's layout goes to the entry as
    its own pointer and strides, no new tensor (a mono voice's one lane
    for both channels, counted once in ``strided_lanes``); a missing lane
    is a null pointer with strides 0; a lane not in f32 is copied and
    counted in ``lane_copies``.  ``launch_lines`` takes such a lane under
    ``require_cuda``'s rule that the operands it checks are contiguous
    (the device rule replaced by the CPU's, the launch by the host
    build's)."""
    v, n = 3, 200
    cfg, params, state, l_in, _ = _freeverb_inputs(v, n, 11, False)
    gains = fv.block_gains(params, v)
    lens = fvk.all_lengths(cfg)
    lane = _time_major(l_in)
    fs = torch.stack([state[k] for k in fv.FS_KEYS], dim=1).contiguous()
    lines = torch.zeros((sum(lens), v))
    tables = fvk.line_tables(lens, "cpu")

    def args_of(l, r):
        before = (FREEVERB.strided_lanes, FREEVERB.lane_copies)
        args, argtypes, _keep, _, _ = FREEVERB.entry_args(
            cfg, l, r, gains, fs.clone(), lines.clone(), n, False, tables)
        assert len(args) == len(argtypes) == len(fvk.TILE_ARGTYPES)
        assert argtypes[:6] == [fvk.P, fvk.LL, fvk.LL, fvk.P, fvk.LL, fvk.LL]
        return args, (FREEVERB.strided_lanes - before[0],
                      FREEVERB.lane_copies - before[1])

    args, counts = args_of(lane, lane)
    assert args[:6] == (lane.data_ptr(), 1, v, lane.data_ptr(), 1, v)
    assert counts == (1, 0)
    args, counts = args_of(lane, None)
    assert args[:6] == (lane.data_ptr(), 1, v, None, 0, 0)
    assert counts == (1, 0)
    args, counts = args_of(l_in, None)
    assert args[:3] == (l_in.data_ptr(), n, 1) and counts == (0, 0)
    wide = lane.double()
    args, counts = args_of(wide, wide)
    assert args[0] not in (wide.data_ptr(), lane.data_ptr())
    assert args[0] == args[3] and counts == (0, 1)
    # the mono lane read in place gives the audio of its contiguous copy
    rows = lane.contiguous()
    got = _k8_host(k8_lib, FREEVERB, cfg, lane, lane, gains, state, n)
    want = _k8_host(k8_lib, FREEVERB, cfg, rows, rows, gains, state, n)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    def require_on_cpu(*tensors):
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("kernel operands must be contiguous")
        return torch.device("cpu")

    def host_launch(entry, argtypes, args, device):
        assert _fn(k8_lib, entry, argtypes)(*args) == 0
    monkeypatch.setattr(fvk, "require_cuda", require_on_cpu)
    monkeypatch.setattr(FREEVERB, "launch", host_launch)
    lines = torch.cat([ring_align_plain(state[k], state[f"{k}_idx"]).T
                       for k in fv.LINE_KEYS]).contiguous()
    before = FREEVERB.strided_lanes
    out_l, out_r = FREEVERB.launch_lines(cfg, lane, lane, gains, fs, lines, n)
    assert FREEVERB.strided_lanes - before == 1
    for g, w in zip((out_l, out_r, fs, lines), want):
        assert torch.equal(g, w)


def test_freeverb_lines_too_long_for_shared_memory_take_the_twin(
        monkeypatch):
    """The rule of ``ops/freeverb_kernel.py``: the shared-memory entry
    where a voice's lines and mix buffers fit one block and a chunk of at
    least 8 fits its lines (1,568 Hz to 96 kHz), the twin where the lines
    do not fit (192 kHz) or are too short (1,000 Hz) -- from the line
    lengths alone.  A build or launch error of the shared-memory entry
    raises; it never selects the twin."""
    want = {1000: None, 1568: 8, 4800: 24, 48000: 128, 96000: 128,
            192000: None}
    for sr, t in want.items():
        lens = fvk.all_lengths(stt.AudioConfig(sample_rate=sr))
        assert fvk.tile_for(lens) == t, sr
        fits = fvk.tile_bytes(lens, 128) <= fvk.SMEM_MAX
        assert fits == (sr < 192000)
        assert (t is None) == (not fits or min(lens) < fvk.TILE_MIN)
        assert fvk.kernel_for(lens) is (fvk.FREEVERB if t
                                        else fvk.FREEVERB_TWIN)
    # the wrapper around a failing shared-memory entry, the card's steps
    # replaced by no-ops on CPU tensors
    v, n = 2, 64
    cfg, params, state, l_in, r_in = _freeverb_inputs(v, n, 0, False)
    twin_calls = []
    monkeypatch.setattr(fvk, "require_cuda", lambda *t: torch.device("cpu"))
    monkeypatch.setattr(RING_ALIGN, "move", lambda *a, **k: None)
    monkeypatch.setattr(fvk.FREEVERB_TWIN, "launch",
                        lambda *a: twin_calls.append(a))

    def broken_build():
        raise RuntimeError("building the Freeverb kernel (K8) failed")
    monkeypatch.setattr(fvk.FREEVERB, "build", broken_build)
    with pytest.raises(RuntimeError, match="building the Freeverb"):
        fvk.render(cfg, l_in, r_in, False, fv.block_gains(params, v), state,
                   n)

    def failed_launch(*a):
        raise RuntimeError("Freeverb kernel (K8) launch failed: CUDA error")
    monkeypatch.setattr(fvk.FREEVERB, "launch", failed_launch)
    with pytest.raises(RuntimeError, match="launch failed"):
        fvk.render(cfg, l_in, r_in, False, fv.block_gains(params, v), state,
                   n)
    assert twin_calls == []


# -- K5/K6 -------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 16, 400, 1024, 5000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_row_gather_on_host_matches_plain(gxx, tmp_path, dtype, k):
    rng = np.random.default_rng(k)
    rows, n = 3, 4500
    table = _rows(dtype, (rows, k), rng)
    idx = torch.from_numpy(rng.integers(-2 * k - 3, 2 * k + 3, (rows, n))
                           .astype(np.int32))
    idx[0] = torch.arange(n, dtype=torch.int32) % k   # a ramp in range
    want = basic.table_lookup_rows_plain(table, idx)
    lib = _host(ROW_GATHER, gxx, tmp_path)
    dt = "f32" if dtype == torch.float32 else "i32"
    for kernel in (ROW_GATHER, ROW_GATHER_LONG):
        out = torch.empty_like(idx, dtype=dtype)
        rc = _fn(lib, f"srk_gather_{kernel.entry}_{dt}", [P, P, P, I, I, I])(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, k, n)
        if kernel.entry == "small" and k > 1024:
            assert rc != 0   # the small entry refuses a long table
            continue
        assert rc == 0
        assert torch.equal(out, want), kernel.name
        assert kernel.launches == 0


# -- K7 ----------------------------------------------------------------------

def _play_inputs(seed, n, k, cv, base):
    rng = np.random.default_rng(seed)
    v = 4
    gate = torch.from_numpy((rng.uniform(size=(v, n)) < 0.003).astype(
        np.float32))
    gate[3, :40] = 1.0                    # high at t = 0
    cvl = (torch.from_numpy(rng.integers(-1, 2, (v, n)).astype(np.float32))
           if cv else None)
    table = torch.from_numpy(rng.standard_normal((v, k)).astype(np.float32))
    return (gate, cvl, table, torch.full((v,), base),
            torch.tensor([0.0, 37.0, k - 3.0, 5.0]),
            torch.tensor([False, True, True, False]),
            torch.tensor([True, False, True, False]),
            torch.tensor([k, k - 100, k // 3, 0], dtype=torch.int32))


def _play_host(lib, args):
    gate, cvl, table, base, pos0, playing0, last0, length = args
    v, n = gate.shape
    out = torch.empty_like(gate)
    pos_end = torch.empty(v)
    play_end, last_end = (torch.empty(v, dtype=torch.int32),
                          torch.empty(v, dtype=torch.int32))
    ints = [playing0.to(torch.int32), last0.to(torch.int32)]
    # the main path's entry, on contiguous [R, n] rows
    vec = int(n % 4 == 0)
    assert _fn(lib, "srk_sample_play", [P, LL, LL, P, LL, LL] + [P] * 10
               + [I] * 5)(
        gate.data_ptr(), n, 1, None if cvl is None else cvl.data_ptr(), n,
        1, table.data_ptr(), base.data_ptr(), pos0.data_ptr(),
        ints[0].data_ptr(), ints[1].data_ptr(), length.data_ptr(),
        out.data_ptr(), pos_end.data_ptr(), play_end.data_ptr(),
        last_end.data_ptr(), v, n, table.shape[1], vec,
        SAMPLE_PLAY.shape) == 0
    return out, pos_end, play_end != 0, last_end != 0


@pytest.mark.parametrize("n", [2500, 1024, 7])
@pytest.mark.parametrize("cv", [False, True])
def test_sample_play_on_host_matches_unfused_on_host_k4(gxx, tmp_path,
                                                         k4_lib, monkeypatch,
                                                         cv, n):
    """Bit for bit against the unfused form whose prefix sum and running
    max are the host build of K4: at base 0.937 the f32 sums round, so this
    holds only if K7 combines in K4's order."""
    scan_lib = k4_lib
    play_lib = _host(SAMPLE_PLAY, gxx, tmp_path / "k7")

    def k4(kind):
        def run(x):
            y = torch.empty_like(x)
            assert _fn(scan_lib, f"srk_scan_{kind}_f32", [P, P, I, I])(
                x.contiguous().data_ptr(), y.data_ptr(), x.shape[0],
                x.shape[1]) == 0
            return y
        return run

    monkeypatch.setattr(smp, "fast_cumsum", k4("sum"))
    monkeypatch.setattr(smp, "fast_cummax", k4("max"))
    args = _play_inputs(n, n, 700, cv, 0.937)
    got = _play_host(play_lib, args)
    want = smp.play_unfused(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[0] != 0).any()
    if cv and n == 2500:
        # the order matters here: the log-doubling sum differs
        plain = smp.play_unfused(*args, plain=True)
        assert not torch.equal(plain[0], got[0]) or \
            not torch.equal(plain[1], got[1])
    assert SAMPLE_PLAY.launches == 0


@pytest.mark.parametrize("cv", [False, True])
def test_sample_play_on_host_matches_plain_at_exact_rates(gxx, tmp_path,
                                                          cv):
    play_lib = _host(SAMPLE_PLAY, gxx, tmp_path)
    args = _play_inputs(3, 3000, 900, cv, 0.5)
    got = _play_host(play_lib, args)
    want = smp.play_unfused(*args, plain=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
