"""The benchmark rehearsed on the CPU, at tiny shapes, before a chip run.

    python3 bench_torch/rehearse.py

1. the work tables against the program's own counts, and the bounds
   (``work/check.py``);
2. the copy of ``farm_params`` against the program's, seeds 0 and 1;
3. the per-layer readers' arithmetic on a made-up trace;
4. every cell of ``BENCHMARK.json`` through its driver, untraced and
   traced, on the CPU with the program's plain engines: the check must
   pass and the last line hold exactly the contract's keys.

It prints what it checked and no device metric: a CPU run measures none.
Exits non-zero on the first failure.
"""

import time

T0 = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def tiny(traffic: dict) -> tuple:
    """A cell's traffic at a size the CPU renders in seconds, and the
    window to give it: past the voice's first gate edge (sample ~2,470),
    where the envelope opens."""
    t = dict(traffic)
    t.update(voices=min(4, t["voices"]), n=4096, check_voices_per_batch=2)
    return t, 0.01


def farm_params_copy() -> list:
    import numpy as np
    import srack_tpu_torch as stt
    from bench_torch.core.patchdesc import PatchDesc, draw_farm_params
    bad = []
    for name in ("subtractive_voice", "reverb_patch"):
        desc = PatchDesc.load(name)
        patch, ids = desc.build(stt)
        for seed in (0, 1):
            ours = draw_farm_params(desc, 16, seed)
            theirs = stt.presets.farm_params(patch, 16, seed)
            for m, pd in ours.items():
                for k, a in pd.items():
                    b = theirs[ids[m]][k].numpy()
                    if a.dtype != b.dtype or not np.array_equal(a, b):
                        bad.append(f"{name} seed {seed} {m}.{k}")
    return bad


def metric_arithmetic() -> list:
    """The readers on a made-up window of 1 s: three renders of 100 ms of
    K1 with 10 ms of torch copies after each, then 2 ms of the benchmark's
    own check."""
    from bench_torch.core import harness
    from bench_torch.core.patchdesc import PatchDesc
    from bench_torch.core.tracing import TraceData
    from bench_torch.work import roofline
    ms = 1_000_000
    device, host, checks = [], [], []
    for r in range(3):
        s = 100 * ms + r * 300 * ms
        device.append((s, s + 100 * ms, "srk_fused_kernel"))
        device.append((s + 100 * ms, s + 110 * ms, "aten::copy_ kernel"))
        device.append((s + 111 * ms, s + 113 * ms, "aten::sum kernel"))
        checks.append((s + 110 * ms, s + 114 * ms))
        host.append((s - 5 * ms, s + 250 * ms, "bench.render"))
    host.append((0, 50 * ms, "aten::empty"))
    data = TraceData(device, {"check": checks}, host, (0, 1000 * ms))
    desc = PatchDesc.load("subtractive_voice")
    counts = {"renders": 3, "voices": 1024, "n": 480000}
    r = harness.Readers(data, desc, counts)
    bound, _ = roofline.bound_ms(*roofline.fused_work(desc, 1024, 480000))
    want = {"fused_roofline_pct": 100 * bound * 3 / 300,
            "torch_ops_ms": 10.0, "device_idle_pct.farm": 66.4}
    bad = []
    for name, value in want.items():
        got = harness.load_file("metrics", name).read(r)
        if got is None or abs(got - value) > 1e-9 * max(1, abs(value)):
            bad.append(f"{name}: {got}, want {value}")
    bd = data.breakdown()
    if bd["device_ops"][0] != ["srk_fused_kernel", 0.3]:
        bad.append(f"breakdown device_ops {bd['device_ops']}")
    idle = dict(bd["idle_gaps"])
    if bd["device_ops"][-1] != ["bench.check (the benchmark's own)", 0.006]:
        bad.append(f"breakdown device_ops {bd['device_ops']}")
    if (abs(idle.get("bench.render", 0) - 0.564) > 1e-9
            or abs(idle.get("aten::empty", 0) - 0.1) > 1e-9):
        bad.append(f"breakdown idle_gaps {bd['idle_gaps']}")
    empty = TraceData([], {}, [], (0, ms))
    r0 = harness.Readers(empty, desc, counts)
    for name in want:
        if harness.load_file("metrics", name).read(r0) is not None:
            bad.append(f"{name} reads a value from an empty trace")
    return bad


def cells(workers: int = 2) -> list:
    from bench_torch.core import harness
    from bench_torch.core.patchdesc import load_json
    bench = harness.load_bench()
    bad = []
    for cell in bench["workloads"]:
        traffic, seconds = tiny(load_json("traffic", cell["traffic"]))
        for trace in (False, True):
            line = harness.run_cell(bench, cell["name"], 2 ** 33 + 5,
                                    seconds, trace, time.perf_counter(),
                                    device="cpu", traffic=traffic,
                                    workers=workers)
            line = json.loads(json.dumps(line))
            keys = LINE_KEYS | ({"breakdown"} if trace else set())
            dev = DEVICE_KEYS | ({"busy_s", "window_s"} if trace else set())
            want = {m["name"] for m in bench["end_to_end"]
                    if harness.applies(m, cell["name"])}
            what = f"{cell['name']} trace={int(trace)}"
            if set(line) != keys or list(line)[-1] != "checks":
                bad.append(f"{what}: keys {list(line)}")
            if set(line["device"]) != dev:
                bad.append(f"{what}: device keys {sorted(line['device'])}")
            if not trace and set(line["metrics"]) != want:
                bad.append(f"{what}: metrics {sorted(line['metrics'])}")
            if not line["correct"]:
                bad.append(f"{what}: not correct: {line['checks']}")
            print(f"{what}: keys ok, correct {line['correct']}, "
                  f"{line['attempted']} attempted", flush=True)
    return bad


def main() -> int:
    for name, step in (("work tables", lambda: __import__(
            "bench_torch.work.check", fromlist=["run"]).run()),
                       ("farm_params copy", farm_params_copy),
                       ("metric arithmetic", metric_arithmetic),
                       ("cells", cells)):
        bad = step()
        print(f"{name}: {'ok' if not bad else 'FAILED'}", flush=True)
        for b in bad:
            print(f"  {b}", flush=True)
        if bad:
            return 1
    print(f"rehearsal ok in {time.perf_counter() - T0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
