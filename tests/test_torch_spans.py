"""The port's own spans (``utils.profiling.span``), on the CPU.

With no profiler recording, the render path never enters a record
function; under a ``torch.profiler`` a block-engine render of
``reverb_patch`` shows ``srk.plan``, then ``srk.render`` holding
``srk.state``, ``srk.lanes`` and ``srk.block.run``, which holds the pre,
stage and post phases and a span per block-phase module, all on one
thread and nested by time, each a host op and not a user annotation (the
profiler mirrors those onto the device's timeline); the build spans count
what ``_COMPILE_CACHE`` and ``cuda_lib.EVENTS`` count."""

import shutil

import pytest
import torch

import srack_tpu_torch as stt
from srack_tpu_torch import compiler
from srack_tpu_torch.ops import cuda_lib
from srack_tpu_torch.utils import profiling
from srack_tpu_torch.utils.profiling import span

CFG = stt.AudioConfig(sample_rate=4800, channels=2)
HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC")
PROBE_SOURCE = 'extern "C" int srk_span_probe(void) { return 7; }\n'


def _reverb_render(voices=2, n=128):
    patch = stt.presets.reverb_patch(CFG)
    return stt.render_batch(patch, n,
                            params=stt.presets.farm_params(patch, voices),
                            engine="block", device="cpu")


def _chain_patch(length: int):
    """A topology of its own: a sine through ``length`` Multiply modules."""
    p = stt.Patch(stt.AudioConfig(sample_rate=4800, channels=1))
    last = p.add("Oscillator", val=-1.0)
    port = "Sine"
    for _ in range(length):
        m = p.add("Multiply", constant=0.999)
        p.connect(last, port, m, "In1")
        last, port = m, 0
    p.connect(last, port, p.output, 0)
    return p


def _srk_spans(prof) -> list:
    """``(name, start, end, thread, is a user annotation)`` of every
    ``srk.`` span, by start (ns, from the profiler's raw events, as a
    trace reader takes them)."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                    e.start_thread_id(), e.is_user_annotation())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("srk.")),
                  key=lambda s: (s[1], -s[2]))


def _profile(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return _srk_spans(prof)


def test_no_profiler_never_enters_record_function(monkeypatch, tmp_path):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with span("srk.anything"):
        pass
    audio, _, _ = _reverb_render(voices=2, n=64)
    assert audio.shape == (2, 2, 64)
    stt.render(_chain_patch(5), 32, device="cpu")
    gxx = shutil.which("g++")
    if gxx is not None:
        cuda_lib.build(PROBE_SOURCE, compiler=gxx, flags=HOST_FLAGS,
                       root=tmp_path)


def test_block_render_spans_nest_on_one_thread():
    _reverb_render(voices=2, n=64)   # the plan built before the trace
    spans = _profile(_reverb_render)
    names = [s[0] for s in spans]
    for name in ("srk.plan", "srk.render", "srk.state", "srk.lanes",
                 "srk.block.run", "srk.block.pre", "srk.block.stage",
                 "srk.block.post", "srk.block.Freeverb"):
        assert names.count(name) == 1, (name, names)
    assert "srk.plan.build" not in names
    assert len({s[3] for s in spans}) == 1
    assert {s[4] for s in spans} == {False}
    at = {s[0]: s for s in spans}

    def inside(inner, outer):
        return at[outer][1] <= at[inner][1] and at[inner][2] <= at[outer][2]

    assert at["srk.plan"][2] <= at["srk.render"][1]
    for name in ("srk.state", "srk.lanes", "srk.block.run"):
        assert inside(name, "srk.render")
    assert at["srk.lanes"][2] <= at["srk.block.run"][1]
    for name in ("srk.block.pre", "srk.block.stage", "srk.block.post"):
        assert inside(name, "srk.block.run")
    assert at["srk.block.pre"][2] <= at["srk.block.stage"][1]
    assert at["srk.block.stage"][2] <= at["srk.block.post"][1]
    # every module span lies in a block phase, the Freeverb in the post one
    phases = [at[p] for p in ("srk.block.pre", "srk.block.post")]
    modules = [s for s in spans if s[0].startswith("srk.block.")
               and s[0].split(".")[2] not in ("run", "pre", "stage", "post")]
    assert {s[0] for s in modules} >= {"srk.block.Freeverb",
                                       "srk.block.Output"}
    for name, s, e, _, _ in modules:
        assert any(p[1] <= s and e <= p[2] for p in phases), name
    assert inside("srk.block.Freeverb", "srk.block.post")


@pytest.mark.parametrize("length", [3, 4])
def test_plan_build_spans_count_cache_misses(length):
    patch = _chain_patch(10 + length)
    before = compiler._COMPILE_CACHE.misses
    spans = _profile(lambda: stt.render(patch, 32, device="cpu"))
    built = compiler._COMPILE_CACHE.misses - before
    names = [s[0] for s in spans]
    assert built == 1
    assert names.count("srk.plan.build") == built
    assert names.count("srk.plan") == 1
    plan, build = (next(s for s in spans if s[0] == n)
                   for n in ("srk.plan", "srk.plan.build"))
    assert plan[1] <= build[1] and build[2] <= plan[2]
    again = _profile(lambda: stt.render(patch, 32, device="cpu"))
    assert compiler._COMPILE_CACHE.misses - before == built
    assert [s[0] for s in again].count("srk.plan.build") == 0
    assert [s[0] for s in again].count("srk.plan") == 1


def test_build_spans_count_events(tmp_path, monkeypatch):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ unavailable")
    before = dict(cuda_lib.EVENTS)
    spans = _profile(lambda: cuda_lib.build(
        PROBE_SOURCE, compiler=gxx, flags=HOST_FLAGS, root=tmp_path))
    path, _ = cuda_lib.build(PROBE_SOURCE, compiler=gxx, flags=HOST_FLAGS,
                             root=tmp_path)   # reused: no compiler run
    assert cuda_lib.EVENTS["nvcc"] - before["nvcc"] == 1
    assert [s[0] for s in spans].count("srk.build.nvcc") == 1

    # the library's load, the build returning the host build's path
    monkeypatch.setattr(cuda_lib, "build", lambda source, what: (path, ""))
    lib = cuda_lib.CudaLib("span_probe", PROBE_SOURCE, "span probe")
    spans = _profile(lib.build)
    spans += _profile(lib.build)   # loaded once
    assert cuda_lib.EVENTS["load"] - before["load"] == 1
    assert [s[0] for s in spans].count("srk.build.load") == 1
    assert lib.build().srk_span_probe() == 7
