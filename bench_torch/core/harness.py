"""One run of one cell: set-up, the measured window, the check, the line.

``BENCHMARK.json`` names the cell's configuration and traffic mix; the
harness loads ``configs/<config>.json``, ``traffic/<mix>.json``, the
mix's driver ``drivers/<driver>.py``, the cell's limits
``limits/<workload>.json`` and one reader ``metrics/<metric>.py`` per
per-layer metric, each by its name.  A driver returns a :class:`Run`; the
harness reads the device's memory peak, has the reference check what the
window produced, and prints the result line.  A run whose process, or
a worker of its reference, holds JAX or the JAX package once the window
has closed prints no result (:func:`check.refuse_foreign`).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from typing import Optional

from . import check, tracing
from .patchdesc import ROOT, PatchDesc, load_json

REPO = ROOT.parent


def load_file(kind: str, name: str):
    """The module ``<kind>/<name>.py`` under the benchmark's folder."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_torch.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Run:
    """What a driver measured: its end-to-end values, the count of work
    attempted and failed, the voices to check, its own compared numbers,
    and counts the metric readers need (``renders``, ``voices``, ``n``)."""
    metrics: dict
    attempted: int
    failed: int
    items: list
    numbers: dict
    counts: dict


class Context:
    """What a driver gets: the cell, the seed, the window's length, the
    device, the program's package, and the window and span helpers."""

    def __init__(self, desc, traffic, seed, seconds, trace, device, t0):
        import srack_tpu_torch
        self.desc = desc
        self.traffic = traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = device
        self.stt = srack_tpu_torch
        self.t0 = t0
        self.tracer = tracing.Tracer(trace)
        self.setup_s = None
        self.marks = [("program imported", time.perf_counter() - t0)]

    def mark(self, what: str):
        """Notes the host time since process start at a step of set-up."""
        self.marks.append((what, time.perf_counter() - self.t0))

    def sync(self):
        import torch
        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()

    def setup_done(self):
        """Marks the end of set-up: everything before it is ``setup_s``."""
        self.sync()
        self.setup_s = time.perf_counter() - self.t0
        self.marks.append(("set-up done", self.setup_s))

    def window(self):
        return self.tracer.window()

    def span(self, name: str):
        return tracing.span(name, self.tracer.enabled)


class Readers:
    """What a per-layer metric reader gets: the trace, the configuration
    and the driver's counts."""

    def __init__(self, trace, desc, counts):
        self.trace = trace
        self.desc = desc
        self.counts = counts


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not readable"


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, t0: float, device: str = "cuda",
             traffic: Optional[dict] = None, workers: int = 0) -> dict:
    """One run of ``workload``; returns the result line as a dict.
    ``traffic`` replaces the mix's file (the tests' tiny shapes)."""
    import torch
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    desc = PatchDesc.load(cell["config"])
    traffic = traffic or load_json("traffic", cell["traffic"])
    driver = load_file("drivers", traffic["driver"])
    ctx = Context(desc, traffic, seed, seconds, trace, device, t0)
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    run = driver.run(ctx)
    check.refuse_foreign("the window has closed")
    print("set-up: " + ", ".join(f"{w} {s:.3f} s" for w, s in ctx.marks),
          file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated() if device.startswith("cuda")
            else 0)
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    gaps = check.reference_gaps(cell["config"], run.items, workers=workers)
    print(f"reference: {len(gaps)} voices in "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    numbers = dict(run.numbers)
    if gaps:
        numbers["audio_gap"] = max(gaps)
    correct, checks = check.judge(numbers, check.limits_for(workload))

    metrics = {}
    if trace:
        data = ctx.tracer.data
        readers = Readers(data, desc, run.counts)
        for m in bench["per_layer"]:
            if applies(m, workload):
                value = load_file("metrics", m["name"]).read(readers)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(run.metrics, setup_s=ctx.setup_s)
        for m in bench["end_to_end"]:
            if applies(m, workload):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if device.startswith("cuda") else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": int(run.attempted),
            "failed": int(run.failed), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = ctx.tracer.data.busy_s
        dev["window_s"] = ctx.tracer.data.window_s
        line["breakdown"] = ctx.tracer.data.breakdown()
    line["checks"] = {k: {"value": _finite(v["value"]),
                          "limit": _finite(v["limit"])}
                      for k, v in checks.items()}
    check.refuse_foreign("the result is made")
    return line


def load_bench() -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return json.loads((REPO / "BENCHMARK.json").read_text())


def main(args, t0: float) -> int:
    bench = load_bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}; BENCHMARK.json has "
              f"{sorted(cells)}", file=sys.stderr)
        return 2
    import torch
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} card(s): no result",
              file=sys.stderr)
        return 2
    try:
        line = run_cell(bench, args.workload, args.seed, args.seconds,
                        bool(args.trace), t0)
    except check.ForeignModules as err:
        print(f"{err}: no result", file=sys.stderr)
        return 3
    print(f"card: {card_line()}; peaks 67 TFLOP/s f32, 3.35 TB/s "
          "(H100 SXM data sheet, at 700 W)", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0
