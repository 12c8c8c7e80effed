"""K10's backward as a reverse pipeline of stage warps, and K7 on tiles of
voices staged in shared memory, checked on the CPU.

* The backward's partition (``partition(..., cost=sweep_ops)``): every
  feedback cycle stays in one stage, and a stage weighs its modules by
  their step's re-run plus their adjoint (``module_ops + adjoint_ops``).
* The split backward's host build (g++, ``-ffp-contract=off``): the same
  lock step of sweep stages and replay warps, scratch buffers, shared
  prefetch buffers and cotangent rings the card runs.  It is held bit for
  bit (``torch.equal``, NaN where NaN) to the host build of the
  one-thread backward, its twin, in every float param's and initial float
  state's cotangent: on the five patches of ``chip_smoke.py``'s K10 check,
  sub-chunks of 8, 16 and 32 samples, n not a multiple of ``t_chunk``.
* The twin's rule: one stage, or no sub-chunk whose buffers fit the
  shared-memory budget and divide ``t_chunk`` into at least one sub-chunk
  per stage; a forced chunk that does not fit raises.
* The split backward against the JAX package's fused VJP in interpret
  mode (``test_k10_split_host_matches_jax_fused_vjp``).
* K10's forward on K1's stage-warp pipeline (``ops/fused.py::
  _generate_pipeline`` with ``t_chunk``), its host build (the same lock
  step and shared buffers as ``srk_fused_host``) held bit for bit to the
  one-thread forward, its twin, in audio, checkpoints ``ck`` and final
  float and int state, NaN where NaN: on the five patches, chunks of 8, 16
  and 32 samples, t_chunk 64 and 128, n = 300, and at n = 1, 23 and 129;
  the split backward fed the split forward's ``ck`` as fed the twin's; the
  twin's rule (one stage, no chunk that fits, none that divides
  ``t_chunk``) and a forced chunk that does not fit raising; the split
  forward against the JAX fused VJP's forward over three checkpoint
  chunks (``test_k10_split_forward_matches_jax_over_checkpoint_chunks``).
* K7 (``csrc/sample_play.cu``): the tiled entry ``srk_sample_play`` bit
  for bit against its unfused form (``modules/sample.py::play_unfused``)
  with the host build of K4 for its two scans, at constant rate and with
  CV, from ``[R, n]`` rows and from transposed views of ``[n, V]`` rows, R
  not a multiple of the tile's voices, n of 2,047, 2,048 and 3,071; and
  its wrapper handing the transposed view to the kernel without a copy.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import srack_tpu_torch as stt
from srack_tpu_torch import interop
from srack_tpu_torch.compiler import tree_items, tree_map
from srack_tpu_torch.modules import sample as smp
from srack_tpu_torch.ops import fused, sample_kernel as sk
from srack_tpu_torch.ops.cuda_lib import build
from srack_tpu_torch.ops.fused_vjp import FusedVJPKernel
from srack_tpu_torch.ops.partition import (adjoint_ops, module_ops,
                                           partition, sweep_ops)
from srack_tpu_torch.ops.scan_kernel import ROW_SCAN

from test_torch_grad import (HOST_FLAGS, HOST_PATCHES, HOST_V, _host_case,
                             _port_grad_patch, assert_rule_b, host_k10)
from test_torch_slice import _complete, _tree

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
T_CHUNK = 128
N = 300          # two whole chunks of 128 and a ragged one
NG = 301         # the same, odd: a group never ends the last chunk


@pytest.fixture(scope="module")
def gxx():
    path = shutil.which("g++")
    if path is None:
        pytest.skip("g++ unavailable")
    return path


@pytest.fixture(scope="module")
def host_libs(gxx, tmp_path_factory):
    """g++ builds of generated sources, shared by the module's tests."""
    root = tmp_path_factory.mktemp("host_builds")
    libs = {}

    def lib(source):
        if source not in libs:
            path, _ = build(source, compiler=gxx, flags=HOST_FLAGS, root=root)
            libs[source] = ctypes.CDLL(str(path))
        return libs[source]
    return lib


def _call(lib, entry, operands, v, n):
    fn = getattr(lib, entry)
    fn.argtypes = [P] * len(operands) + [I, I]
    fn.restype = I
    assert fn(*[t.data_ptr() for t in operands], v, n) == 0


def _same(a, b) -> bool:
    """Equal bit for bit, NaN where NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all()) and \
        torch.equal(a.isnan(), b.isnan())


def _bwd(lib_of, kernel, operands, v, n):
    """``(dpf, dsf)`` of one host launch of ``kernel``'s backward."""
    pf, pi, lanes, ck, cta, ctf = operands
    scr = torch.zeros(kernel.scratch_shape(v, n), dtype=torch.int32)
    dpf = torch.zeros((max(kernel.layout.n_pf, 1), v))
    dsf = torch.zeros((max(kernel.layout.n_sf, 1), v))
    _call(lib_of(kernel.bwd.source), "srk_vjp_bwd_host",
          (pf, pi, lanes, ck, cta, ctf, scr, dpf, dsf), v, n)
    return dpf, dsf


def _bwd_operands(lib_of, kernel, params, state, xs, n, seed):
    """The forward's checkpoints (host build) and random audio and final
    state cotangents: the backward's operands."""
    v = HOST_V
    with torch.no_grad():
        lanes, pi, si, floats = kernel.operands(params, state, n, xs)
        pf, sf = kernel.float_rows(floats, v, "cpu")
    audio = torch.empty((v, kernel.compiled.cfg.channels, n))
    ck = torch.empty((max(-(-n // kernel.t_chunk), 1), kernel.s_rows, v),
                     dtype=torch.int32)
    _call(lib_of(kernel.fwd.source), "srk_vjp_fwd_host",
          (pf, pi, sf, si, lanes, torch.zeros(1), audio,
           torch.empty_like(sf), torch.empty_like(si), ck), v, n)
    rng = np.random.default_rng(seed)
    cta = torch.from_numpy(rng.standard_normal(audio.shape).astype(
        np.float32))
    ctf = torch.from_numpy(rng.standard_normal(
        (max(kernel.layout.n_sf, 1), v)).astype(np.float32))
    return pf, pi, lanes, ck, cta, ctf


def _fwd(lib_of, kernel, operands, v, n):
    """``(audio, sf_out, si_out, ck)`` of one host launch of ``kernel``'s
    forward, from outputs filled with a pattern the kernel must overwrite
    (NaN, -7)."""
    pf, pi, sf, si, lanes = operands
    audio = torch.full((v, kernel.compiled.cfg.channels, n), float("nan"))
    sf_out = torch.full_like(sf, float("nan"))
    si_out = torch.full_like(si, -7)
    ck = torch.full((max(-(-n // kernel.t_chunk), 1), kernel.s_rows, v), -7,
                    dtype=torch.int32)
    _call(lib_of(kernel.fwd.source), "srk_vjp_fwd_host",
          (pf, pi, sf, si, lanes, torch.zeros(1), audio, sf_out, si_out, ck),
          v, n)
    return audio, sf_out, si_out, ck


def _fwd_operands(kernel, params, state, xs, n):
    """The forward's packed operands ``(pf, pi, sf, si, lanes)``."""
    with torch.no_grad():
        lanes, pi, si, floats = kernel.operands(params, state, n, xs)
        pf, sf = kernel.float_rows(floats, HOST_V, "cpu")
    return pf, pi, sf, si, lanes


# -- the backward's partition -------------------------------------------------

@pytest.mark.parametrize("name", HOST_PATCHES)
def test_bwd_partition_keeps_feedback_cycles_and_weighs_adjoints(name):
    _, compiled, _, _, _ = _host_case(name, 8)
    part = FusedVJPKernel(compiled).partition
    assert part == partition(compiled, cost=sweep_ops)
    stage_of = part.stage_of()
    for mid in compiled.plan:
        assert sweep_ops(compiled, mid) == (module_ops(compiled, mid)
                                            + adjoint_ops(compiled, mid))
        for c in compiled.instances[mid][2]:
            if c is not None and compiled.plan_pos[c[0]] >= \
                    compiled.plan_pos[mid]:
                # a carried read: the whole cycle in one stage
                lo, hi = compiled.plan_pos[mid], compiled.plan_pos[c[0]]
                assert {stage_of[m] for m in compiled.plan[lo:hi + 1]} == \
                    {stage_of[mid]}
    assert part.costs == tuple(sum(sweep_ops(compiled, m) for m in mods)
                               for mods in part.stages)
    assert part.n_stages > 1
    if name == "feedback_patch":
        # a feedback source's wire read in a later stage as well
        assert any(w in compiled.fb_keys for w, _, _ in part.wires)


# -- the split backward against its twin ---------------------------------------

@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("name", HOST_PATCHES)
def test_split_bwd_on_host_is_bit_identical_to_its_twin(host_libs, name,
                                                        chunk):
    patch, compiled, params, state, xs = _host_case(name, N)
    split = FusedVJPKernel(compiled, xs, T_CHUNK)
    if fused.bwd_shape(compiled, split.partition, split.lanes, split.layout,
                       chunk, T_CHUNK).nbytes > fused.SMEM_BUDGET:
        with pytest.raises(ValueError, match="shared memory"):
            FusedVJPKernel(compiled, xs, T_CHUNK, chunk=chunk)
        return
    split = FusedVJPKernel(compiled, xs, T_CHUNK, chunk=chunk)
    twin = FusedVJPKernel(compiled, xs, T_CHUNK, stages=1)
    assert not split.twin and twin.twin and split.chunk == chunk
    assert split.bwd.name == "fused_vjp_bwd"
    assert twin.bwd.name == "fused_vjp_bwd_twin"
    ops = _bwd_operands(host_libs, split, params, state, xs, N, 3)
    got = _bwd(host_libs, split, ops, HOST_V, N)
    want = _bwd(host_libs, twin, ops, HOST_V, N)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert got[0].abs().nan_to_num().max() > 0
    assert split.bwd.launches == 0 and twin.bwd.launches == 0


@pytest.mark.parametrize("n", [1, 23, 129])
def test_split_bwd_short_renders_are_bit_identical(host_libs, n):
    """n below one sub-chunk, below one chunk, one past a chunk."""
    patch, compiled, params, state, xs = _host_case("lane_check_patch", n)
    split = FusedVJPKernel(compiled, xs, T_CHUNK)
    twin = FusedVJPKernel(compiled, xs, T_CHUNK, stages=1)
    ops = _bwd_operands(host_libs, split, params, state, xs, n, 5)
    got = _bwd(host_libs, split, ops, HOST_V, n)
    want = _bwd(host_libs, twin, ops, HOST_V, n)
    assert _same(got[0], want[0]) and _same(got[1], want[1])


# -- the twin's rule ------------------------------------------------------------

def test_the_twin_runs_only_where_its_rule_sends_a_plan():
    compiled = stt.compile_patch(_port_grad_patch("subtractive_voice"))
    assert not FusedVJPKernel(compiled).twin
    # one stage
    assert FusedVJPKernel(compiled, stages=1).twin
    # chunks of 16 hold two sub-chunks of 8, fewer than the 4 stages
    kernel = FusedVJPKernel(compiled, t_chunk=16)
    assert kernel.partition.n_stages == 4 and kernel.twin
    assert kernel.bwd.name == "fused_vjp_bwd_twin"
    # a chunk whose buffers exceed the budget raises, it never falls back
    with pytest.raises(ValueError, match="shared memory"):
        fused.generate_source(compiled, mode="bwd", split=kernel.partition,
                              chunk=64, t_chunk=256)
    # a plan of one module: one stage
    p = stt.Patch(stt.AudioConfig(sample_rate=4800, channels=1))
    assert FusedVJPKernel(stt.compile_patch(p)).twin


# -- the split forward against its twin -----------------------------------------

@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("t_chunk", [64, 128])
@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("name", HOST_PATCHES)
def test_split_fwd_on_host_is_bit_identical_to_its_twin(host_libs, name,
                                                        chunk, t_chunk,
                                                        group):
    patch, compiled, params, state, xs = _host_case(name, NG)
    split = FusedVJPKernel(compiled, xs, t_chunk, fwd_chunk=chunk,
                           fwd_group=group)
    twin = FusedVJPKernel(compiled, xs, t_chunk, stages=1)
    assert not split.fwd_twin and twin.fwd_twin
    assert split.fwd_chunk == chunk and split.fwd_group == group
    assert twin.fwd_group is None
    assert split.fwd.name == "fused_vjp_fwd"
    assert twin.fwd.name == "fused_vjp_fwd_twin"
    assert split.fwd_partition == partition(compiled, carried=True)
    ops = _fwd_operands(split, params, state, xs, NG)
    got = _fwd(host_libs, split, ops, HOST_V, NG)
    want = _fwd(host_libs, twin, ops, HOST_V, NG)
    for g, w in zip(got, want):
        assert _same(g, w)
    assert got[0].abs().nan_to_num().max() > 0
    assert (got[3] != -7).all()    # every checkpoint row written
    assert split.fwd.launches == 0 and twin.fwd.launches == 0


@pytest.mark.parametrize("n", [1, 23, 129])
def test_split_fwd_short_renders_are_bit_identical(host_libs, n):
    """n below one chunk, below one checkpoint chunk, one past one."""
    patch, compiled, params, state, xs = _host_case("lane_check_patch", n)
    split = FusedVJPKernel(compiled, xs, T_CHUNK)
    twin = FusedVJPKernel(compiled, xs, T_CHUNK, stages=1)
    assert not split.fwd_twin
    ops = _fwd_operands(split, params, state, xs, n)
    got = _fwd(host_libs, split, ops, HOST_V, n)
    want = _fwd(host_libs, twin, ops, HOST_V, n)
    for g, w in zip(got, want):
        assert _same(g, w)


@pytest.mark.parametrize("name", HOST_PATCHES)
def test_split_bwd_fed_by_the_split_fwd_matches_the_twins_checkpoints(
        host_libs, name):
    """The split backward on the split forward's checkpoints gives the
    cotangents it gives on the one-thread forward's."""
    patch, compiled, params, state, xs = _host_case(name, N)
    split = FusedVJPKernel(compiled, xs, T_CHUNK)
    twin = FusedVJPKernel(compiled, xs, T_CHUNK, stages=1)
    assert not split.fwd_twin and not split.twin
    fwd_ops = _fwd_operands(split, params, state, xs, N)
    ck_split = _fwd(host_libs, split, fwd_ops, HOST_V, N)[3]
    ck_twin = _fwd(host_libs, twin, fwd_ops, HOST_V, N)[3]
    pf, pi, _, _, lanes = fwd_ops
    rng = np.random.default_rng(7)
    cta = torch.from_numpy(rng.standard_normal(
        (HOST_V, compiled.cfg.channels, N)).astype(np.float32))
    ctf = torch.from_numpy(rng.standard_normal(
        (max(split.layout.n_sf, 1), HOST_V)).astype(np.float32))
    got = _bwd(host_libs, split, (pf, pi, lanes, ck_split, cta, ctf), HOST_V,
               N)
    want = _bwd(host_libs, split, (pf, pi, lanes, ck_twin, cta, ctf), HOST_V,
                N)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert got[0].abs().nan_to_num().max() > 0


def test_the_forward_twin_runs_only_where_its_rule_sends_a_plan(monkeypatch):
    compiled = stt.compile_patch(_port_grad_patch("subtractive_voice"))
    kernel = FusedVJPKernel(compiled)
    assert not kernel.fwd_twin and kernel.fwd.name == "fused_vjp_fwd"
    assert kernel.fwd_chunk == 32 and kernel.fwd_partition.n_stages == 4
    # one stage
    assert FusedVJPKernel(compiled, stages=1).fwd_twin
    p = stt.Patch(stt.AudioConfig(sample_rate=4800, channels=1))
    one = FusedVJPKernel(stt.compile_patch(p))
    assert one.fwd_twin and one.fwd.name == "fused_vjp_fwd_twin"
    # no chunk of 8-32 divides t_chunk 12; t_chunk 16 takes 16, 24 takes 8
    assert FusedVJPKernel(compiled, t_chunk=12).fwd_twin
    assert FusedVJPKernel(compiled, t_chunk=16).fwd_chunk == 16
    assert FusedVJPKernel(compiled, t_chunk=24).fwd_chunk == 8
    # no chunk whose rings, lane buffers and tile fit the budget
    need = fused.smem_layout(kernel.fwd_partition, fused.stage_lanes(
        compiled, kernel.fwd_partition, (), None, kernel.layout),
        compiled.cfg.channels, 8).nbytes
    monkeypatch.setattr(fused, "SMEM_BUDGET", need - 4)
    tight = FusedVJPKernel(compiled)
    assert tight.fwd_twin and tight.fwd.name == "fused_vjp_fwd_twin"
    # a forced chunk that does not fit raises, it never falls back
    with pytest.raises(ValueError, match="shared memory"):
        FusedVJPKernel(compiled, fwd_chunk=8)
    monkeypatch.undo()
    # so does one that does not divide t_chunk
    with pytest.raises(ValueError, match="t_chunk"):
        FusedVJPKernel(compiled, t_chunk=48, fwd_chunk=32)


# -- against JAX -----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_vjp(tmp_path_factory):
    import subprocess
    import sys
    from test_torch_slice import ROOT, WORKER, _env
    out = tmp_path_factory.mktemp("jax_vjp") / "ref.npz"
    proc = subprocess.run([sys.executable, str(WORKER), str(out), "vjp",
                           "vjp_long"],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def test_k10_split_host_matches_jax_fused_vjp(jax_vjp, gxx, tmp_path):
    """The split backward (t_chunk 128: 4 stages, sub-chunks of 16) against
    the JAX package's fused VJP in interpret mode (t_chunk=16): subtractive
    voice, V=2, n=32, the gradient of ``mean(audio ** 2)`` with respect to
    the params."""
    compiled = stt.compile_patch(_port_grad_patch("subtractive_voice"))
    mids = list(compiled.instances)
    params = interop.params_from_numpy(
        _complete(_tree(jax_vjp, "vjp/params"), mids, state=False))
    state = interop.state_from_numpy(
        _complete(_tree(jax_vjp, "vjp/state"), mids, state=True))
    kernel = host_k10(compiled, (), T_CHUNK, gxx, tmp_path)
    assert not kernel.twin
    assert kernel.fwd.name == "fused_vjp_fwd"
    p = tree_map(lambda a: a.clone().requires_grad_(True), params)
    audio, _ = kernel.apply(p, state, 32, {})
    np.testing.assert_array_equal(audio.detach().numpy(),
                                  jax_vjp["vjp/audio"])
    (audio ** 2).mean().backward()
    want = dict(tree_items(_tree(jax_vjp, "vjp/grads")))
    nonzero = 0
    for path, leaf in tree_items(p):
        assert_rule_b(leaf.grad.numpy(), want[path], str(path))
        nonzero += bool(np.abs(want[path]).max() > 0)
    assert nonzero >= 4


def test_k10_split_forward_matches_jax_over_checkpoint_chunks(jax_vjp, gxx,
                                                            tmp_path):
    """The split forward (t_chunk 128: 4 stages, chunks of 32) against the
    JAX package's fused VJP forward in interpret mode (t_chunk 128) over n
    = 300, three checkpoint chunks: subtractive voice, V=2; the audio and
    the final state, bit for bit."""
    compiled = stt.compile_patch(_port_grad_patch("subtractive_voice"))
    mids = list(compiled.instances)
    params = interop.params_from_numpy(
        _complete(_tree(jax_vjp, "vjp_long/params"), mids, state=False))
    state = interop.state_from_numpy(
        _complete(_tree(jax_vjp, "vjp_long/state"), mids, state=True))
    kernel = host_k10(compiled, (), T_CHUNK, gxx, tmp_path)
    assert kernel.fwd.name == "fused_vjp_fwd" and kernel.fwd_chunk == 32
    with torch.no_grad():
        audio, final = kernel.apply(params, state, 300, {})
    np.testing.assert_array_equal(audio.numpy(), jax_vjp["vjp_long/audio"])
    assert np.abs(jax_vjp["vjp_long/audio"]).max() > 0
    want = dict(tree_items(_complete(_tree(jax_vjp, "vjp_long/final"), mids,
                                     state=True)))
    got = dict(tree_items(interop.to_numpy(final)))
    assert set(got) == set(want) and want
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        np.testing.assert_array_equal(got[path], w, err_msg=str(path))
    assert kernel.fwd.launches == 0


# -- K7 ---------------------------------------------------------------------------

ROWS = 13        # not a multiple of any tile's voices


def _play_case(seed, n, cv):
    rng = np.random.default_rng(seed)
    k = 700
    gate = torch.from_numpy((rng.uniform(size=(ROWS, n)) < 0.003).astype(
        np.float32))
    gate[3, :40] = 1.0                    # high at t = 0
    gate[5, 1023:1025] = 1.0              # an edge across a chunk boundary
    # whole octaves: exp2 exact in torch and in the kernel's exp2f, while
    # base * 2^cv at base 0.937 still rounds in the prefix sum
    cvl = (torch.from_numpy(rng.integers(-2, 2, (ROWS, n)).astype(
        np.float32)) if cv else None)
    table = torch.from_numpy(rng.standard_normal((ROWS, k)).astype(
        np.float32))
    flags = torch.from_numpy(rng.uniform(size=(2, ROWS)) < 0.5)
    length = torch.from_numpy(rng.integers(0, k + 1, ROWS).astype(np.int32))
    length[0] = 0
    return (gate, cvl, table, torch.full((ROWS,), 0.937),
            torch.from_numpy(rng.uniform(0, k, ROWS).astype(np.float32)),
            flags[0], flags[1], length)


def _play(lib, args, shape):
    gate, cvl, table, base, pos0, playing0, last0, length = args
    rows, n = gate.shape
    out = torch.empty((rows, n))
    pos_end = torch.empty(rows)
    ends = [torch.empty(rows, dtype=torch.int32) for _ in range(2)]
    ints = [playing0.to(torch.int32), last0.to(torch.int32)]
    tail = (table.data_ptr(), base.data_ptr(), pos0.data_ptr(),
            ints[0].data_ptr(), ints[1].data_ptr(), length.data_ptr(),
            out.data_ptr(), pos_end.data_ptr(), ends[0].data_ptr(),
            ends[1].data_ptr(), rows, n, table.shape[1])
    fn = lib.srk_sample_play
    fn.restype = I
    c = gate if cvl is None else cvl
    vec = all(t.stride(1) == 1 and t.stride(0) % 4 == 0 for t in (gate, c))
    fn.argtypes = [P, LL, LL, P, LL, LL] + [P] * 10 + [I] * 5
    assert fn(gate.data_ptr(), gate.stride(0), gate.stride(1),
              None if cvl is None else cvl.data_ptr(), c.stride(0),
              c.stride(1), *tail, int(vec), shape) == 0
    return out, pos_end, ends[0] != 0, ends[1] != 0


@pytest.mark.parametrize("layout", ["rows", "transposed"])
@pytest.mark.parametrize("n", [2047, 2048, 3071])
@pytest.mark.parametrize("cv", [False, True])
def test_tiled_sample_play_on_host_matches_unfused_on_host_k4(
        host_libs, monkeypatch, cv, n, layout):
    """Bit for bit against the unfused form whose prefix sum and running
    max are the host build of K4 (at base 0.937 the f32 sums round, so
    this holds only if K7 combines in K4's order), from rows and from
    transposed views."""
    args = _play_case(n, n, cv)
    k4 = host_libs(ROW_SCAN.source)

    def scan(kind):
        def run(x):
            x = x.contiguous()
            y = torch.empty_like(x)
            fn = getattr(k4, f"srk_scan_{kind}_f32")
            fn.argtypes, fn.restype = [P, P, I, I], I
            assert fn(x.data_ptr(), y.data_ptr(), x.shape[0],
                      x.shape[1]) == 0
            return y
        return run
    monkeypatch.setattr(smp, "fast_cumsum", scan("sum"))
    monkeypatch.setattr(smp, "fast_cummax", scan("max"))
    want = smp.play_unfused(*args)
    lanes = args[:2]
    if layout == "transposed":   # [V, n] views of [n, V] rows
        lanes = tuple(None if a is None else a.T.contiguous().T
                      for a in lanes)
        assert lanes[0].stride() == (1, ROWS)
    got = _play(host_libs(sk.SAMPLE_PLAY.source), lanes + args[2:],
                sk.SAMPLE_PLAY.shape)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[0] != 0).any() and got[2].any()
    if cv:   # the order shows: the log-doubling sum differs
        plain = smp.play_unfused(*args, plain=True)
        assert not torch.equal(plain[0], got[0]) or \
            not torch.equal(plain[1], got[1])
    assert sk.SAMPLE_PLAY.launches == 0


def test_sample_play_wrapper_hands_the_view_over_without_a_copy(
        monkeypatch):
    """The tiled entry gets the transposed view's own pointer and strides
    (no 16-byte copies across voices)."""
    args = _play_case(1, 2048, True)
    views = tuple(a.T.contiguous().T for a in args[:2])
    seen = {}

    def launch(self, entry, argtypes, largs, device):
        seen[self.name] = largs
    monkeypatch.setattr(sk, "require_cuda", lambda *t: torch.device("cpu"))
    monkeypatch.setattr(sk.SamplePlay, "launch", launch)
    sk.SAMPLE_PLAY.run(*views, *args[2:])
    new = seen["sample_play"]
    assert new[0] == views[0].data_ptr() and new[1:3] == (1, ROWS)
    assert new[3] == views[1].data_ptr() and new[4:6] == (1, ROWS)
    assert new[-2] == 0   # no 16-byte copies along time
