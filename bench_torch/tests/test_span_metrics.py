"""The readers of the program's spans, ``entry_idle_ms`` and
``block_idle_ms``, on traces made by hand, and on a CPU trace of a real
block-engine render (the span names the program opens are the ones the
readers look for).

    python3 -m pytest -q bench_torch/tests/test_span_metrics.py
"""

from __future__ import annotations

import pytest

from bench_torch.core import harness, tracing
from bench_torch.core.patchdesc import PatchDesc
from bench_torch.core.tracing import TraceData
from bench_torch.metrics import _spans

MS = 1_000_000
# the device busy everywhere in the 1 s window but in four gaps:
# [150, 250] half inside the first srk.render span; [290, 295] inside the
# second srk.render and outside its srk.block.run; [320, 340] inside that
# srk.block.run; [500, 520] under no program span
BUSY = [(0, 150), (250, 290), (295, 320), (340, 500), (520, 1000)]
HOST = [(80, 230, "bench.render"), (90, 100, "srk.plan"),
        (100, 200, "srk.render"), (120, 140, "srk.lanes"),
        (260, 430, "bench.render"), (270, 278, "srk.plan"),
        (280, 420, "srk.render"), (300, 400, "srk.block.run"),
        (310, 350, "srk.block.stage"), (505, 515, "aten::empty")]
DESC = PatchDesc.load("reverb_patch")


def _readers(host=HOST, busy=BUSY, renders=2):
    device = [(s * MS, e * MS, "srk_fused_kernel") for s, e in busy]
    data = TraceData(device, {}, [(s * MS, e * MS, n) for s, e, n in host],
                     (0, 1000 * MS))
    return harness.Readers(data, DESC, {"renders": renders, "voices": 4,
                                        "n": 480})


def _read(name, r):
    return harness.load_file("metrics", name).read(r)


def test_a_gap_half_inside_a_render_span_counts_half_to_entry():
    r = _readers(host=[(100, 200, "srk.render")])
    assert _read("entry_idle_ms", r) == pytest.approx(50 / 2)


def test_a_gap_in_the_block_engine_counts_to_block_not_entry():
    r = _readers(host=[(280, 420, "srk.render"),
                       (300, 400, "srk.block.run")], renders=1)
    assert _read("block_idle_ms", r) == pytest.approx(20.0)
    assert _read("entry_idle_ms", r) == pytest.approx(5.0)


def test_a_gap_under_no_program_span_counts_to_neither():
    r = _readers(host=[(100, 101, "srk.render"), (300, 301, "srk.block.run"),
                       (505, 515, "aten::empty"),
                       (490, 530, "bench.render")], renders=1)
    assert _read("entry_idle_ms", r) == 0.0
    assert _read("block_idle_ms", r) == 0.0


def test_device_work_inside_a_span_is_not_idle():
    r = _readers(host=[(0, 150, "srk.render"), (250, 290, "srk.block.run")],
                 renders=1)
    assert _read("entry_idle_ms", r) == 0.0
    assert _read("block_idle_ms", r) == 0.0


def test_the_split_adds_up_to_the_idle_time():
    r = _readers()
    entry, block = _read("entry_idle_ms", r), _read("block_idle_ms", r)
    assert entry == pytest.approx((50 + 5) / 2)
    assert block == pytest.approx(20 / 2)
    idle = (1.0 - r.trace.busy_s / r.trace.window_s) * 1000 / 2
    outside = _spans.overlap_ns(
        r.trace.gaps(), _spans.minus([(0, 1000 * MS)], _spans.spans_of(
            r, ("srk.plan", "srk.render")))) / MS / 2
    assert outside == pytest.approx((50 + 20) / 2)
    assert entry + block + outside == pytest.approx(idle)


@pytest.mark.parametrize("name", ["entry_idle_ms", "block_idle_ms"])
def test_no_program_span_reads_none(name):
    r = _readers(host=[(80, 230, "bench.render"), (505, 515, "aten::empty")])
    assert _read(name, r) is None
    assert _read(name, _readers(renders=0)) is None


def test_block_reads_none_without_the_block_engine():
    r = _readers(host=[(90, 100, "srk.plan"), (100, 200, "srk.render")])
    assert _read("block_idle_ms", r) is None
    assert _read("entry_idle_ms", r) == pytest.approx(50 / 2)


@pytest.mark.parametrize("a, b, want", [
    ([(0, 10)], [], [(0, 10)]),
    ([(0, 10)], [(0, 10)], []),
    ([(0, 10), (20, 30)], [(5, 25)], [(0, 5), (25, 30)]),
    ([(0, 10)], [(2, 3), (4, 5), (9, 12)], [(0, 2), (3, 4), (5, 9)]),
    ([(5, 6)], [(0, 1), (2, 3)], [(5, 6)]),
])
def test_interval_difference(a, b, want):
    assert _spans.minus(a, b) == want


def test_the_program_spans_on_a_cpu_trace():
    import srack_tpu_torch as stt
    patch = stt.presets.reverb_patch(stt.AudioConfig(sample_rate=4800,
                                                     channels=2))
    params = stt.presets.farm_params(patch, 2)
    stt.render_batch(patch, 32, params=params, engine="block", device="cpu")
    tracer = tracing.Tracer(True)
    with tracer.window():
        for _ in range(2):
            with tracing.span("render", True):
                stt.render_batch(patch, 64, params=params, engine="block",
                                 device="cpu")
    r = harness.Readers(tracer.data, DESC, {"renders": 2, "voices": 2,
                                            "n": 64})
    # no device events on the CPU: the whole window is idle
    entry, block = _read("entry_idle_ms", r), _read("block_idle_ms", r)
    assert entry > 0 and block > 0
    assert not any(name.startswith("srk.") for _, _, name in r.trace.device)
    assert entry + block <= r.trace.window_s * 1e3 / 2
