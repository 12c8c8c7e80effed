"""K1 and K3 as a pipeline of stage warps, and one-voice renders on the
kernels, checked on the CPU.

* The partition (``ops/partition.py``): stage indices never fall along a
  wire, a feedback carry's cycle stays in one stage, the sequencer splits
  into four stages of under 35 % of its operations each, a patch of one
  module gives one stage.
* The split source's host build (g++, ``-ffp-contract=off``): the same
  lock step, chunks, sample groups, shared-memory wire rings and lane
  buffers the card runs, in a loop over stages and lanes.  It is held bit
  for bit to the scan engine (K1) or the stage's torch loop (K3), and to
  the one-thread build, at 37 voices (a partial last CTA), groups of 1, 2,
  4 and 8 samples and n not a multiple of the chunk or of the group.
* Sample groups: in each stage's group every load comes before the first
  module call and every store after the last; a launch counts under its
  group.
* K2 (buffer-feedback mode) on the same pipeline: its stages, the
  feedback ring's condition on the chunk (``block >= (h - g + 1) * T``
  for a key read in stage g and written in stage h), and the split host
  build bit for bit against the one-thread K2 and the scan engine, at
  blocks of 64 and 1,024 and chunks of 16, 32 and the default; a chunk
  one ring step too long shows on the host.
* The audio tile: two buffers past every ring; the store warp that stores
  it keeps every preset's chunk; only K1's, K2's and K10's forward sources
  have one; bit for bit at any last CTA; the host's lock step shows a tile
  of one buffer.
* One unbatched voice on the card takes the kernels' engines; on the CPU
  the one-voice path (a batch of one) equals the unbatched scan engine.
"""

import contextlib
import ctypes
import re
import shutil
import types

import numpy as np
import pytest
import torch

import srack_tpu_torch as stt
from srack_tpu_torch.block_engine import wire_key
from srack_tpu_torch.compiler import tree_map
from srack_tpu_torch.ops import fused
from srack_tpu_torch.ops.cuda_lib import build
from srack_tpu_torch.ops.partition import (MAX_STAGES, module_ops,
                                           one_stage, partition)

HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
              "-shared", "-fPIC")
SR = 4800
V, N = 37, 300
NG = 301    # odd: the last chunk is no multiple of the chunk or of a group
GROUPS = (1, 2, 4, 8)
PRESETS = ("subtractive_voice", "sequencer_patch", "feedback_patch",
           "sine_patch", "gradient_patch", "kernel_check_patch",
           "lane_check_patch")
BLOCK_PRESETS = ("reverb_patch", "block_check_patch", "drum_machine",
                 "sampler_kit", "kit_check_patch")


@pytest.fixture(scope="module")
def gxx():
    path = shutil.which("g++")
    if path is None:
        pytest.skip("g++ unavailable")
    return path


@pytest.fixture(scope="module")
def host_root(tmp_path_factory):
    """One build directory for the module's g++ builds: a source built
    once (the one-thread twins) is found by its hash."""
    return tmp_path_factory.mktemp("host_builds")


def _patch(name, channels=1, **cfg):
    """``(patch, automation)`` of a preset at 4,800 Hz."""
    config = stt.AudioConfig(sample_rate=SR, channels=channels, **cfg)
    if name == "lane_check_patch":
        return stt.presets.lane_check_patch(
            stt.AudioConfig(sample_rate=SR, channels=2))
    if name == "block_check_patch":
        return stt.presets.block_check_patch(config)
    if name == "kernel_check_patch":
        return stt.presets.kernel_check_patch(
            stt.AudioConfig(sample_rate=SR, channels=3)), ()
    if name == "reverb_patch":
        return stt.presets.reverb_patch(
            stt.AudioConfig(sample_rate=SR, channels=2)), ()
    return getattr(stt.presets, name)(config), ()


def _compiled(name, **cfg):
    patch, autos = _patch(name, **cfg)
    return patch, stt.compile_patch(patch, automation=autos)


def _reads(compiled, plan):
    """Within-sample reads ``(src, sink)`` inside ``plan``."""
    return [(c[0], mid) for mid in plan
            for c in compiled.instances[mid][2]
            if c is not None and c[0] in plan
            and compiled.plan_pos[c[0]] < compiled.plan_pos[mid]]


# -- the partition -------------------------------------------------------------

@pytest.mark.parametrize("name", PRESETS + BLOCK_PRESETS)
def test_stage_indices_are_monotone_along_every_wire(name):
    _, compiled = _compiled(name)
    plan = (compiled.plan if name in PRESETS
            else compiled.block_program().stage_plan)
    part = partition(compiled, plan)
    g = part.stage_of()
    assert sorted(g) == sorted(plan)
    assert 1 <= part.n_stages <= MAX_STAGES
    assert all(part.stages) and all(len(s) for s in part.stages)
    for src, sink in _reads(compiled, plan):
        assert g[src] <= g[sink], (src, sink)
    assert part.costs == tuple(sum(module_ops(compiled, m) for m in s)
                               for s in part.stages)
    # the cross-stage wires are exactly the reads that change stage, each
    # with the last stage that reads it
    cross = {}
    for mid in plan:
        for c in compiled.instances[mid][2]:
            if (c is not None and c[0] in plan and g[c[0]] < g[mid]
                    and compiled.plan_pos[c[0]] < compiled.plan_pos[mid]):
                cross[c] = max(cross.get(c, 0), g[mid])
    assert part.wires == tuple(sorted((w, g[w[0]], b)
                                      for w, b in cross.items()))


def test_feedback_cycles_stay_in_one_stage():
    _, compiled = _compiled("feedback_patch")
    assert len(compiled.fb_keys) == 2
    part = partition(compiled)
    g = part.stage_of()
    for src, port in compiled.fb_keys:
        # the carried reads: a sink planned at or before the source
        sinks = [mid for mid in compiled.plan
                 for c in compiled.instances[mid][2] if c == (src, port)
                 and compiled.plan_pos[src] >= compiled.plan_pos[mid]]
        assert sinks
        for sink in sinks:
            # the carry's source, its sink and everything planned between
            # them (the cycle) share the stage
            lo, hi = compiled.plan_pos[sink], compiled.plan_pos[src]
            assert {g[m] for m in compiled.plan[lo:hi + 1]} == {g[src]}
    # in a buffer-mode stage the delayed wires are lanes: no carry binds
    _, buffered = _compiled("feedback_patch", block_size=64,
                            buffer_feedback=True)
    prog = buffered.block_program()
    assert prog.stage_fb_in
    free = partition(buffered, prog.stage_plan, carried=False)
    bound = partition(buffered, prog.stage_plan, carried=True)
    assert max(free.costs) < max(bound.costs)


def test_sequencer_splits_into_four_stages_under_35_percent_each():
    _, compiled = _compiled("sequencer_patch")
    part = partition(compiled)
    total = sum(module_ops(compiled, m) for m in compiled.plan)
    assert total == 629 and part.n_stages == 4
    assert all(c < 0.35 * total for c in part.costs), part.costs


def test_the_costliest_module_sets_the_pace_of_the_voice():
    _, compiled = _compiled("subtractive_voice")
    part = partition(compiled)
    vco = max(compiled.plan, key=lambda m: module_ops(compiled, m))
    assert compiled.instances[vco][0].type_name == "Oscillator"
    assert max(part.costs) == module_ops(compiled, vco) == 67
    assert sum(part.costs) == 178 and part.n_stages == 4
    # ties go to fewer cross-stage wires, then fewer stages
    assert len(part.wires) == 3


def test_one_module_patch_gives_one_stage():
    p = stt.Patch(stt.AudioConfig(sample_rate=SR, channels=1))
    osc = p.add("Oscillator")
    p.connect(osc, "Sine", p.output, 0)
    compiled = stt.compile_patch(p)
    assert partition(compiled).n_stages == 1
    bare = stt.Patch(stt.AudioConfig(sample_rate=SR, channels=1))
    assert partition(stt.compile_patch(bare)).n_stages == 1
    # a one-stage partition emits the one-thread kernel, byte for byte
    _, voice = _compiled("subtractive_voice")
    assert fused.generate_source(voice, split=one_stage(voice)) == \
        fused.generate_source(voice)
    assert fused.FusedKernel(voice, stages=1).source == \
        fused.generate_source(voice)
    assert partition(voice, max_stages=1) == one_stage(voice)


def test_chunk_fits_the_shared_memory_budget():
    for name in PRESETS:
        _, compiled = _compiled(name)
        kernel = fused.FusedKernel(compiled, compiled._make_xs(
            compiled.default_params, 0, 8, {}))
        if kernel.partition.n_stages == 1:
            assert kernel.chunk is None and kernel.threads == 32
            continue
        # a warp per stage and the store warp
        assert kernel.threads == 32 * (kernel.partition.n_stages + 1)
        assert f"#define SRK_THREADS {kernel.threads}\n" in kernel.source
        assert kernel.chunk >= fused.CHUNK_MIN
        assert kernel.chunk & (kernel.chunk - 1) == 0
        assert kernel.smem_bytes <= fused.SMEM_BUDGET
        assert f"#define SRK_T {kernel.chunk}\n" in kernel.source
        # the build hash covers the partition and the chunk: they are in
        # the source
        other = fused.FusedKernel(compiled, kernel.lanes,
                                  chunk=kernel.chunk // 2)
        assert other.source != kernel.source


def test_a_plan_too_wide_for_shared_memory_runs_one_thread_per_voice():
    """120 oscillators summed by a chain of Adds: 93 wires cross stages,
    287 KB of rings at the shortest chunk.  The kernel takes the
    one-thread form rather than fail at launch."""
    p = stt.Patch(stt.AudioConfig(sample_rate=SR, channels=1))
    oscs = [p.add("Oscillator") for _ in range(120)]
    acc = None
    for osc in oscs:
        add = p.add("Add")
        p.connect(osc, "Sine", add, 0)
        if acc is not None:
            p.connect(acc, 0, add, 1)
        acc = add
    p.connect(acc, 0, p.output, 0)
    compiled = stt.compile_patch(p)
    part = partition(compiled)
    assert part.n_stages == 4
    lanes_of = fused.stage_lanes(compiled, part, (), None,
                                 fused.Layout.of(compiled))
    assert fused.pick_chunk(part, lanes_of, 1) is None
    assert fused.smem_layout(part, lanes_of, 1, fused.CHUNK_MIN).nbytes > \
        fused.SMEM_BUDGET
    kernel = fused.FusedKernel(compiled)
    assert kernel.partition.n_stages == 1 and kernel.chunk is None
    assert kernel.source == fused.generate_source(compiled)


# -- the split source's host build -----------------------------------------------

def _host(kernel, gxx, root):
    lib = ctypes.CDLL(str(build(kernel.source, compiler=gxx,
                                flags=HOST_FLAGS, root=root)[0]))
    fn = lib.srk_fused_host
    fn.argtypes, fn.restype = fused.ARGTYPES, ctypes.c_int
    return fn


def _host_run(kernel, fn, params, state, n, lanes, out_shape):
    pf, pi, sf, si, lanes_p, ring, v = kernel.pack(params, state, n, lanes)
    out = torch.full(out_shape(v), float("nan"))
    sf_out, si_out = torch.empty_like(sf), torch.empty_like(si)
    assert fn(pf.data_ptr(), pi.data_ptr(), sf.data_ptr(), si.data_ptr(),
              lanes_p.data_ptr(), ring.data_ptr(), out.data_ptr(),
              sf_out.data_ptr(), si_out.data_ptr(), v, n) == 0
    return out, kernel.finish(sf_out, si_out, ring, v)


def _assert_state_equal(got, want):
    for path_key in ("states", "fb"):
        assert set(got[path_key]) == set(want[path_key])
    for mid, sd in want["states"].items():
        for key, w in sd.items():
            assert torch.equal(got["states"][mid][key], w), (mid, key)
    for k, w in want["fb"].items():
        assert torch.equal(got["fb"][k], w), k


def _voice_lanes(name, patch, compiled, params, n, seed):
    """lane_check_patch's lanes: a random gate on its driven Input, a pitch
    lane on the VCO's automated val, its Noise from the port's
    generator."""
    if name != "lane_check_patch":
        return {}
    rng = np.random.default_rng(seed)
    ids = {inst.name: inst.id for inst in patch}
    return compiled._make_xs(params, seed, n, {
        ids["gate"]: torch.from_numpy(
            (rng.uniform(size=(V, n)) < 0.3).astype(np.float32)),
        compiled._auto_key(ids["vco"], "val"): torch.from_numpy(
            rng.uniform(-1.5, 0.5, (V, n)).astype(np.float32))})


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("chunk", [None, 16, 64])
@pytest.mark.parametrize("name", ["subtractive_voice", "sequencer_patch",
                                  "feedback_patch", "lane_check_patch"])
def test_split_kernel_on_host_is_bit_identical(gxx, host_root, name, chunk,
                                               group):
    patch, compiled = _compiled(name)
    params = stt.presets.farm_params(patch, V, seed=5)
    state = tree_map(lambda a: a.expand((V,) + a.shape).contiguous(),
                     compiled.init_state())
    xs = _voice_lanes(name, patch, compiled, params, NG, 5)
    kernel = fused.FusedKernel(compiled, xs, chunk=chunk, group=group)
    assert kernel.partition.n_stages > 1 and kernel.group == group
    assert f"#define SRK_U {group}\n" in kernel.source
    assert NG % kernel.chunk % 2
    single = fused.FusedKernel(compiled, xs, stages=1)
    channels = compiled.cfg.channels
    shape = (lambda v: (v, channels, NG))
    audio, final = _host_run(kernel, _host(kernel, gxx, host_root), params,
                             state, NG, xs, shape)
    audio1, final1 = _host_run(single, _host(single, gxx, host_root), params,
                               state, NG, xs, shape)
    want, want_final = compiled.render_scan(params, state, NG, batched=True,
                                            nograd=True, xs=xs)
    assert torch.equal(audio, want)
    assert torch.equal(audio, audio1)
    _assert_state_equal(final, want_final)
    _assert_state_equal(final, final1)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("name", ["block_check_patch", "kit_check_patch",
                                  "drum_machine", "feedback_buffer"])
def test_split_stage_kernel_on_host_is_bit_identical(gxx, host_root, name,
                                                     chunk, group):
    if name == "feedback_buffer":
        patch, compiled = _compiled("feedback_patch", block_size=64,
                                    buffer_feedback=True)
    else:
        patch, compiled = _compiled(name)
    prog = compiled.block_program()
    params = stt.presets.farm_params(patch, V, seed=7)
    state = tree_map(lambda a: a.expand((V,) + a.shape).contiguous(),
                     compiled.init_state())
    rng = np.random.default_rng(7)
    # the stage's input wires (in buffer mode its delayed wires too) and
    # its Noise as random lanes
    keys = ([wire_key(w) for w in prog.stage_in]
            + [wire_key(("fb",) + k) for k in prog.stage_fb_in]
            + [m for m in prog.stage_plan
               if compiled.instances[m][0].make_xs is not None])
    assert keys
    lanes = {k: torch.from_numpy(rng.uniform(-1, 1, (V, NG)).astype(
        np.float32)) for k in keys}
    kernel = fused.StageKernel(prog, lanes, chunk=chunk, group=group)
    assert kernel.partition.n_stages > 1 and NG % kernel.chunk % 2
    assert kernel.group == group
    if chunk is None and group == fused.pick_group(
            kernel.chunk, kernel.partition, kernel.layout):
        assert kernel.source == prog.stage_kernel(lanes).source
    single = fused.StageKernel(prog, lanes, stages=1)
    stage_state = {"states": {m: state["states"][m]
                              for m in prog.stage_plan},
                   "fb": {} if prog.buffer_mode else state["fb"]}
    shape = (lambda v: (len(prog.stage_out), NG, v))
    outs, final = _host_run(kernel, _host(kernel, gxx, host_root), params,
                            stage_state, NG, lanes, shape)
    outs1, final1 = _host_run(single, _host(single, gxx, host_root), params,
                              stage_state, NG, lanes, shape)
    derived = compiled.derived_params(params)
    want, want_final = prog.stage_plain(
        {m: derived[m] for m in prog.stage_plan}, stage_state, lanes, NG)
    assert torch.equal(outs, outs1)
    for j, w in enumerate(prog.stage_out):
        assert torch.equal(outs[j].T, want[w]), w
    for mid in prog.stage_plan:
        for key, w in want_final["states"][mid].items():
            assert torch.equal(final["states"][mid][key], w), (mid, key)
            assert torch.equal(final1["states"][mid][key], w), (mid, key)


# -- K2 on the pipeline ------------------------------------------------------

def _buffer_case(block):
    patch, compiled = _compiled("feedback_patch", block_size=block,
                                buffer_feedback=True)
    params = stt.presets.farm_params(patch, V, seed=block)
    state = tree_map(lambda a: a.expand((V,) + a.shape).contiguous(),
                     compiled.init_state())
    return compiled, params, state


def _ring_ok(compiled, part, chunk):
    return all(compiled.cfg.block_size >= (h - g + 1) * chunk
               for _, g, h in fused.ring_stages(compiled, part))


@pytest.mark.parametrize("block", [8, 16, 17, 24, 32, 48, 64, 100, 1024])
def test_k2_chunk_never_outruns_its_feedback_ring(block):
    """``pick_chunk`` (through ``FusedKernel``) never yields a chunk T with
    ``block < (h - g + 1) * T``; where no T >= 8 fits, K2 runs one thread
    per voice; an explicit chunk past the ring raises."""
    _, compiled = _compiled("feedback_patch", block_size=block,
                            buffer_feedback=True)
    for stages in (2, 3, 4):
        kernel = fused.FusedKernel(compiled, stages=stages)
        part = partition(compiled, carried=False, max_stages=stages)
        spans = fused.ring_stages(compiled, part)
        assert {k for k, _, _ in spans} == set(compiled.fb_keys)
        assert all(g <= h for _, g, h in spans)
        limit = fused.ring_chunk_limit(compiled, part)
        assert _ring_ok(compiled, part, limit)
        assert limit == fused.CHUNK_MAX or not _ring_ok(compiled, part,
                                                        limit + 1)
        if kernel.partition.n_stages == 1:
            assert kernel.chunk is None and limit < fused.CHUNK_MIN
            continue
        assert kernel.partition == part
        assert fused.CHUNK_MIN <= kernel.chunk <= limit
        assert _ring_ok(compiled, part, kernel.chunk)
        if limit < 2 * fused.CHUNK_MAX:
            with pytest.raises(ValueError, match="feedback ring"):
                fused.FusedKernel(compiled, stages=stages, chunk=2 * limit)
    # block 64: the key m1#0 is read a stage before its source
    if block == 64:
        assert fused.ring_chunk_limit(compiled, partition(
            compiled, carried=False)) == 32


# K2's render length by block: at block 66, no multiple of the chunk, the
# chunks straddle the blocks, and three blocks end in a part chunk
BUFFER_N = {64: 384, 66: 198, 1024: 2048}


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("chunk", [None, 16, 32])
@pytest.mark.parametrize("block", [64, 1024, 66])
def test_split_buffer_kernel_on_host_is_bit_identical(gxx, host_root, block,
                                                      chunk, group):
    """K2 split into stages, on the host: audio, state and the final fb
    ring bit for bit equal to the one-thread K2 and to the scan engine; two
    halves cut at a block boundary equal the whole.  (Buffer mode renders
    whole blocks; at blocks of 64 and 1,024 every chunk is whole and a
    group never ends one.)"""
    compiled, params, state = _buffer_case(block)
    n = BUFFER_N[block]
    kernel = fused.FusedKernel(compiled, chunk=chunk, group=group)
    assert kernel.name == "fused_voice_buffer"
    assert kernel.partition.n_stages == 3 and kernel.group == group
    assert kernel.chunk == (chunk or 32)
    assert "#define SRK_FB_BLOCK" in kernel.source
    single = fused.FusedKernel(compiled, stages=1)
    assert single.partition.n_stages == 1
    shape = (lambda v: (v, 1, n))
    fn = _host(kernel, gxx, host_root)
    audio, final = _host_run(kernel, fn, params, state, n, {}, shape)
    audio1, final1 = _host_run(single, _host(single, gxx, host_root), params,
                               state, n, {}, shape)
    want, want_final = compiled.render_scan(params, state, n, batched=True,
                                            nograd=True)
    assert torch.equal(audio, want) and torch.equal(audio, audio1)
    assert (audio != 0).any()
    _assert_state_equal(final, want_final)
    _assert_state_equal(final, final1)
    half = n // block // 2 * block
    a1, s1 = _host_run(kernel, fn, params, state, half, {},
                       lambda v: (v, 1, half))
    a2, s2 = _host_run(kernel, fn, params, s1, n - half, {},
                       lambda v: (v, 1, n - half))
    assert torch.equal(torch.cat([a1, a2], dim=-1), audio)
    _assert_state_equal(s2, final)


def test_k2_ring_read_in_its_source_stage_caps_the_chunk(gxx, tmp_path):
    """A mixer that feeds itself a block late: its stage both reads and
    writes the key, and copies a chunk's slots before the chunk's writes,
    so the block bounds the chunk too (block 16: T = 16, not 32).  The
    split host build equals the one-thread K2 and the scan engine bit for
    bit."""
    p = stt.Patch(stt.AudioConfig(sample_rate=SR, block_size=16, channels=1,
                                  buffer_feedback=True))
    lfo, vco, mix = p.add("Oscillator"), p.add("Oscillator"), p.add(
        "Mono Mixer")
    p.connect(lfo, "Sine", vco, 0)
    p.connect(vco, "Sine", mix, 0)
    p.connect(mix, 0, mix, 1)
    p.connect(mix, 0, p.output, 0)
    compiled = stt.compile_patch(p)
    kernel = fused.FusedKernel(compiled)
    spans = fused.ring_stages(compiled, kernel.partition)
    assert [(g, h) for _, g, h in spans] == [(2, 2)]
    assert kernel.chunk == 16 == fused.ring_chunk_limit(compiled,
                                                        kernel.partition)
    n = 160
    params = stt.presets.farm_params(p, V, seed=3)
    state = tree_map(lambda a: a.expand((V,) + a.shape).contiguous(),
                     compiled.init_state())
    shape = (lambda v: (v, 1, n))
    audio, final = _host_run(kernel, _host(kernel, gxx, tmp_path), params,
                             state, n, {}, shape)
    single = fused.FusedKernel(compiled, stages=1)
    audio1, final1 = _host_run(single, _host(single, gxx, tmp_path), params,
                               state, n, {}, shape)
    want, want_final = compiled.render_scan(params, state, n, batched=True,
                                            nograd=True)
    assert torch.equal(audio, want) and torch.equal(audio, audio1)
    assert (audio != 0).any()
    _assert_state_equal(final, want_final)
    _assert_state_equal(final, final1)


def test_a_ring_one_chunk_too_short_shows_on_the_host(gxx, tmp_path,
                                                     monkeypatch):
    """At block 64 the ring allows chunks of 32 (m1#0 is read in stage 0
    and written in stage 1).  With the condition lifted, a chunk of 64
    reads each slot in the step that writes it: the host build, which runs
    stage 0 before stage 1, then reads the block before last, and the audio
    departs from the scan engine."""
    compiled, params, state = _buffer_case(64)
    n = 6 * 64
    monkeypatch.setattr(fused, "ring_chunk_limit", lambda c, p: 1 << 20)
    kernel = fused.FusedKernel(compiled, chunk=64)
    audio, _ = _host_run(kernel, _host(kernel, gxx, tmp_path), params,
                         state, n, {}, lambda v: (v, 1, n))
    want, _ = compiled.render_scan(params, state, n, batched=True,
                                   nograd=True)
    assert torch.equal(audio[..., :64], want[..., :64])
    assert not torch.equal(audio, want)


# -- sample groups -----------------------------------------------------------

_STORE = re.compile(r"(\bsm|\baudio|\bring)\[[^\]]*\] = |srk_output\(")
_LOAD = re.compile(r"= (sm|lanes|ring)\[")
_CALL = re.compile(r"\bsrk_\w+<")


def _group_body(source, g):
    """The reads, calls and writes of stage ``g``'s group loop."""
    fn = source.split(f"SRK_HD void srk_st{g}_chunk(")[1].split("\n}\n")[0]
    body = fn.split("  for (; tc + SRK_U <= cnt; tc += SRK_U) {\n")[1]
    body = body.split("\n  }\n")[0]
    head, rest = body.split("    // group: reads\n")
    reads, rest = rest.split("    // group: calls\n")
    calls, writes = rest.split("    // group: writes\n")
    return head, reads.splitlines(), calls.splitlines(), writes.splitlines()


@pytest.mark.parametrize("name", ["subtractive_voice", "reverb_patch"])
def test_a_group_reads_before_its_first_call_and_writes_after_its_last(
        name):
    """In every stage's group of the headline voice (K1) and the reverb's
    serial stage (K3), each load of shared memory, a lane or a ring comes
    before the group's first module call and each store after its last;
    each module has one call a sample, each in the calls."""
    patch, compiled = _compiled(name)
    if name == "reverb_patch":
        prog = compiled.block_program()
        kernel = fused.StageKernel(prog, ())
        plan = prog.stage_plan
    else:
        kernel = fused.FusedKernel(compiled)
        plan = compiled.plan
    u = kernel.group
    assert u > 1 and f"#define SRK_U {u}\n" in kernel.source
    assert f"groups of SRK_U = {u} samples" in kernel.source
    for g, mods in enumerate(kernel.partition.stages):
        head, reads, calls, writes = _group_body(kernel.source, g)
        assert not _STORE.search(head) and not _LOAD.search(head)
        assert calls and writes
        assert not any(_STORE.search(x) or _CALL.search(x) for x in reads)
        assert not any(_STORE.search(x) or _LOAD.search(x) or "sm[" in x
                       or "lanes[" in x or "audio[" in x for x in calls)
        assert not any(_LOAD.search(x) or _CALL.search(x) for x in writes)
        assert all(_STORE.search(x) or re.match(r"    fb_\w+ = w_", x)
                   for x in writes)
        steps = [m for m in mods if m in plan and m != compiled.output_id]
        for mid in steps:
            made = [x for x in calls if re.search(
                rf"\bw_{mid}_u\d+\);", x)]
            assert len(made) == u, (g, mid)
    # the headline's VCO: every sample's pitch before the first step
    if name == "subtractive_voice":
        _, _, calls, _ = _group_body(kernel.source, 1)
        first = min(i for i, x in enumerate(calls) if "srk_osc_core<" in x)
        pitches = [i for i, x in enumerate(calls) if "srk_osc_pitch<" in x]
        assert len(pitches) == u and max(pitches) < first


def _host_launches(monkeypatch, gxx, root, *kernels):
    """Send each kernel's launches to the host entry of its g++ build, as
    if the card had run them: the launch and its counts are the real
    ones."""
    for k in kernels:
        lib = ctypes.CDLL(str(build(k.source, compiler=gxx,
                                    flags=HOST_FLAGS, root=root)[0]))

        class Entry:
            def __init__(self, fn):
                self.fn = fn

            def __call__(self, *args):
                self.fn.argtypes = self.argtypes[:-1]
                self.fn.restype = self.restype
                return self.fn(*args[:-1])
        shim = types.SimpleNamespace(
            srk_fused_launch=Entry(lib.srk_fused_host))
        monkeypatch.setattr(k, "build", lambda shim=shim: shim)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=None))


@pytest.mark.parametrize("name, group", [
    ("subtractive_voice", 8), ("sequencer_patch", 2), ("reverb_patch", 8),
    ("drum_machine", 4), ("sampler_kit", 4), ("kit_check_patch", 8)])
def test_a_stage_that_steps_a_table_takes_smaller_groups(name, group):
    """``pick_group``'s default: 8 samples, 4 where a stage reads a
    sequencer's table (the drum machine's and the sampler kit's stages),
    2 where a group of the costliest stage would pass ``GROUP_OPS`` (the
    sequencer patch's K1); the kit check's sequencers run before its
    stage."""
    _, compiled = _compiled(name)
    if name in PRESETS:
        kernel = fused.FusedKernel(compiled)
    else:
        prog = compiled.block_program()
        kernel = prog.stage_kernel(
            [wire_key(w) for w in prog.stage_in]
            + [m for m in prog.stage_plan
               if compiled.instances[m][0].make_xs is not None])
    assert kernel.partition.n_stages > 1 and kernel.group == group
    assert f"#define SRK_U {group}" in kernel.source


def test_a_launch_counts_under_its_group(gxx, host_root, monkeypatch):
    """The headline voice's launch counts once under its group, beside its
    entry; the one-thread form has no group and counts none."""
    patch, compiled = _compiled("subtractive_voice")
    kernel = fused.FusedKernel(compiled)
    single = fused.FusedKernel(compiled, stages=1)
    assert kernel.group == fused.pick_group(kernel.chunk, kernel.partition,
                                            kernel.layout)
    assert single.group is None and single.chunk is None
    _host_launches(monkeypatch, gxx, host_root, kernel, single)
    params = stt.presets.farm_params(patch, V, seed=9)
    state = tree_map(lambda a: a.expand((V,) + a.shape).contiguous(),
                     compiled.init_state())
    audio = {}
    for k in (kernel, single):
        pf, pi, sf, si, lanes, ring, v = k.pack(params, state, NG, {})
        out = torch.empty((v, 1, NG))
        ops = (pf, pi, sf, si, lanes, ring, out, torch.empty_like(sf),
               torch.empty_like(si))
        k.launch("srk_fused_launch", fused.ARGTYPES,
                 tuple(t.data_ptr() for t in ops) + (v, NG),
                 torch.device("cpu"))
        audio[k] = out
    assert kernel.launches == 1 and kernel.by_entry == {"srk_fused_launch": 1}
    assert single.launches == 1 and single.by_entry == kernel.by_entry
    assert torch.equal(audio[kernel], audio[single])


# -- the audio tile and the store warp -----------------------------------------

TILED = ("subtractive_voice", "sequencer_patch", "feedback_patch",
         "lane_check_patch", "kernel_check_patch", "feedback_buffer")
# the 16,384-voice farm on an H100: 512 CTAs over 132 SMs of 228 KB of
# shared memory and 64 warps each, 1 KB of shared memory reserved a CTA
FARM_VOICES, SMS, SM_BYTES, SM_WARPS = 16384, 132, 228 * 1024, 64
CTA_RESERVED = 1024


def _fused_case(name, **kw):
    """A split K1 (``feedback_buffer``: K2, block 1,024) of a preset at
    4,800 Hz."""
    if name == "feedback_buffer":
        _, compiled = _compiled("feedback_patch", block_size=1024,
                                buffer_feedback=True)
        return fused.FusedKernel(compiled, **kw)
    _, compiled = _compiled(name)
    return fused.FusedKernel(compiled, compiled._make_xs(
        compiled.default_params, 0, 8, {}), **kw)


def _stage_case(name):
    """K3 of a block preset's serial stage, its input wires and Noise as
    lanes."""
    _, compiled = _compiled(name)
    prog = compiled.block_program()
    keys = ([wire_key(w) for w in prog.stage_in]
            + [m for m in prog.stage_plan
               if compiled.instances[m][0].make_xs is not None])
    return fused.StageKernel(prog, keys)


@pytest.mark.parametrize("chunk", [None, 8, 16])
@pytest.mark.parametrize("name", TILED)
def test_the_tile_is_two_buffers_past_every_ring(name, chunk):
    """The audio tile is the layout's last block: two buffers of a padded
    row per voice and channel, past every wire ring, lane buffer and K2
    ring chunk."""
    kernel = _fused_case(name, chunk=chunk)
    assert kernel.partition.n_stages > 1
    lanes_of, channels, rings, _ = fused.split_needs(
        kernel.compiled, kernel.partition, kernel.lanes, None, kernel.layout)
    sm = fused.smem_layout(kernel.partition, lanes_of, channels,
                           kernel.chunk, rings)
    assert sm.nbytes == kernel.smem_bytes and channels >= 1
    assert sm.floats == sm.tile + 2 * channels * 32 * (kernel.chunk + 1)
    ends = [off + slots * kernel.chunk * 32 for _, off, slots in sm.wires]
    ends += [off + 2 * kernel.chunk * 32 for _, off in sm.lanes]
    ends += [off + kernel.chunk * 32 for _, off in sm.fb]
    assert max(ends, default=0) <= sm.tile


@pytest.mark.parametrize("name", ["subtractive_voice", "feedback_patch",
                                  "sequencer_patch", "feedback_buffer",
                                  "reverb_patch"])
def test_the_store_warp_changes_no_chunk(name):
    """The tile's second buffer keeps every preset at the longest chunk
    within the shared-memory budget, and every CTA of the 16,384-voice
    farm of the headline voice resident at once, store warp and all."""
    kernel = (_stage_case(name) if name == "reverb_patch"
              else _fused_case(name))
    assert kernel.partition.n_stages > 1
    assert kernel.chunk == fused.CHUNK_MAX
    assert kernel.smem_bytes <= fused.SMEM_BUDGET
    assert kernel.warps == kernel.partition.n_stages + (
        name != "reverb_patch")
    if name == "subtractive_voice":
        per_sm = -(-(FARM_VOICES // 32) // SMS)
        assert per_sm * (kernel.smem_bytes + CTA_RESERVED) <= SM_BYTES
        assert per_sm * kernel.warps <= SM_WARPS


@pytest.mark.parametrize("name", ["subtractive_voice", "feedback_buffer",
                                  "k10_forward"])
def test_a_tiled_source_stores_its_tile_from_a_store_warp(name):
    """K1's, K2's and K10's forward split sources: one warp more than the
    stages, and only that warp (at each step and after the last) and the
    host's lock step store the tile; the Output stage's warp only writes
    it."""
    if name == "k10_forward":
        from srack_tpu_torch.ops.fused_vjp import FusedVJPKernel
        _, compiled = _compiled("subtractive_voice")
        kernel = FusedVJPKernel(compiled)
        assert not kernel.fwd_twin
        source, stages = kernel.fwd.source, kernel.fwd_partition.n_stages
    else:
        kernel = _fused_case(name)
        source, stages = kernel.source, kernel.partition.n_stages
    assert f"#define SRK_THREADS {32 * (stages + 1)}\n" in source
    card = source[source.index("__global__"):source.index("#else")]
    warp = card[card.index("} else {  // the store warp"):]
    assert card.count("srk_tile_store(") == warp.count("srk_tile_store(") == 2
    host = source[source.index("_host("):]
    assert host.count("srk_tile_store(") == 1


@pytest.mark.parametrize("name", ["reverb_patch", "block_check_patch",
                                  "one_thread", "one_thread_buffer"])
def test_an_untiled_source_has_no_store_warp(name):
    """K3 (its outputs stream per sample) and the one-thread forms (they
    store straight to ``[V, C, n]``) have no tile, so no store warp."""
    if name == "one_thread":
        kernel = fused.FusedKernel(_compiled("subtractive_voice")[1],
                                   stages=1)
    elif name == "one_thread_buffer":
        kernel = _fused_case("feedback_buffer", stages=1)
    else:
        kernel = _stage_case(name)
        assert kernel.warps == kernel.partition.n_stages > 1
        assert f"#define SRK_THREADS {kernel.threads}\n" in kernel.source
    assert "srk_tile_store" not in kernel.source
    assert "store warp" not in kernel.source


def test_a_tile_of_one_buffer_shows_on_the_host(gxx, tmp_path):
    """The host's lock step stores a chunk after the step in which the
    Output stage writes the next one, as the card's store warp may: with
    the tile's two buffers made one, the audio is wrong."""
    v = 32
    patch, compiled = _compiled("subtractive_voice")
    kernel = fused.FusedKernel(compiled)
    params = stt.presets.farm_params(patch, v, seed=13)
    state = tree_map(lambda a: a.expand((v,) + a.shape).contiguous(),
                     compiled.init_state())
    want, _ = compiled.render_scan(params, state, NG, batched=True,
                                   nograd=True)
    shape = (lambda v: (v, 1, NG))
    audio, _ = _host_run(kernel, _host(kernel, gxx, tmp_path), params, state,
                         NG, {}, shape)
    assert torch.equal(audio, want)
    assert kernel.source.count("(c & 1)") == 2
    kernel.source = kernel.source.replace("(c & 1)", "0")
    audio, _ = _host_run(kernel, _host(kernel, gxx, tmp_path), params, state,
                         NG, {}, shape)
    assert not torch.equal(audio, want)


@pytest.mark.parametrize("v", [1, 32, 33, 37])
@pytest.mark.parametrize("name", ["subtractive_voice", "feedback_buffer"])
def test_the_store_warp_is_bit_identical_at_any_last_cta(gxx, host_root,
                                                        name, v):
    """With a last CTA of 1, 32, 1 and 5 voices the host build's store warp
    gives the scan engine's audio and final state."""
    kernel = _fused_case(name)
    compiled = kernel.compiled
    buffer = compiled.cfg.buffer_feedback
    n = 2 * compiled.cfg.block_size if buffer else NG
    patch = (stt.presets.feedback_patch if buffer
             else stt.presets.subtractive_voice)(compiled.cfg)
    params = stt.presets.farm_params(patch, v, seed=17)
    state = tree_map(lambda a: a.expand((v,) + a.shape).contiguous(),
                     compiled.init_state())
    audio, final = _host_run(kernel, _host(kernel, gxx, host_root), params,
                             state, n, {}, lambda v: (v, 1, n))
    want, want_final = compiled.render_scan(params, state, n, batched=True,
                                            nograd=True)
    assert torch.equal(audio, want) and (audio != 0).any()
    _assert_state_equal(final, want_final)


# -- one voice on the kernels ------------------------------------------------

def test_one_voice_on_the_card_takes_the_kernels_engines():
    """``auto_engine`` with ``batched=False`` on a CUDA device: the engine
    a batched render takes.  Pure logic: no card is needed to ask."""
    _, voice = _compiled("subtractive_voice")
    _, reverb = _compiled("reverb_patch")
    assert voice.auto_engine(False, "cuda") == "fused"
    assert reverb.auto_engine(False, "cuda") == "block"
    for compiled in (voice, reverb):
        assert compiled.auto_engine(False, "cpu") == "scan"
        assert compiled.auto_engine(False, torch.device("cuda", 0)) == \
            compiled.auto_engine(True, "cuda")


class _BatchOfOne:
    """A stand-in for K1 on the CPU: the scan engine on the batch it is
    given, recording the shapes."""

    def __init__(self, compiled):
        self.compiled, self.calls = compiled, []

    def render(self, params, state, n, xs):
        self.calls.append({k: tuple(a.shape) for k, a in xs.items()})
        assert all(t.shape[0] == 1 for t in
                   stt.compiler.tree_leaves(params)
                   + stt.compiler.tree_leaves(state))
        return self.compiled.render_scan(params, state, n, batched=True,
                                         nograd=True, xs=xs)


@pytest.mark.parametrize("name", ["lane_check_patch", "feedback_patch"])
def test_one_voice_runs_the_fused_engine_as_a_batch_of_one(monkeypatch,
                                                            name):
    patch, compiled = _compiled(name)
    stub = _BatchOfOne(compiled)
    monkeypatch.setattr(compiled, "fused", lambda lanes=(): stub)
    n = 200
    drivers = {}
    if name == "lane_check_patch":
        ids = {inst.name: inst.id for inst in patch}
        drivers = {ids["gate"]: (np.arange(n) % 37 < 3).astype(np.float32)}
    audio, probes, final = compiled.render(n, key=3, drivers=drivers,
                                           engine="fused", device="cpu")
    want, _, want_final = compiled.render(n, key=3, drivers=drivers,
                                          engine="scan", device="cpu")
    assert len(stub.calls) == 1 and probes == {}
    # the lanes were made in their unbatched form, then given a voice axis
    assert all(shape == (1, n) for shape in stub.calls[0].values())
    if name == "lane_check_patch":
        assert len(stub.calls[0]) == 2   # the gate driver and the Noise
    assert torch.equal(audio, want) and audio.shape == (
        compiled.cfg.channels, n)
    _assert_state_equal(final, want_final)


@pytest.mark.parametrize("name", ["reverb_patch", "drum_machine"])
def test_one_voice_block_path_equals_the_unbatched_scan(name):
    """One voice through the block engine's plain versions (the path the
    card takes on its kernels) against today's unbatched scan engine:
    audio within the block engine's tolerance, the state unbatched."""
    patch, compiled = _compiled(name)
    n = 256
    audio, _, final = stt.render(patch, n, key=5, engine="block",
                                 device="cpu")
    want, _, want_final = stt.render(patch, n, key=5, engine="scan",
                                     device="cpu")
    assert audio.shape == want.shape == (compiled.cfg.channels, n)
    assert float(audio.abs().max()) > 0
    torch.testing.assert_close(audio, want, atol=5e-6, rtol=0)
    for mid, sd in want_final["states"].items():
        for key, w in sd.items():
            assert final["states"][mid][key].shape == w.shape, (mid, key)
    # the stream without voices= goes the same way, block after block
    blocks = [a for a, _, _ in stt.render_stream(
        patch, n_blocks=2, engine="block", device="cpu")]
    again, _, _ = stt.render(patch, 2 * compiled.cfg.block_size,
                             engine="block", device="cpu",
                             segment=compiled.cfg.block_size)
    torch.testing.assert_close(torch.cat(blocks, dim=-1), again, atol=0,
                               rtol=0)
