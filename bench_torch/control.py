"""The control of a cell's check.

    python3 bench_torch/control.py --workload <name> --seeds <n> ...

For each seed, the voices the cell's check compares, at the cell's own
size (a window of the benchmark's ``run_seconds``), rendered by the plain
reference computed in bfloat16 in the program's place, against the
reference in f32: the control's ``audio_gap``, which the cell's limit has
to fail.  The program's own readings are the compared numbers that
``run.py`` prints.  One JSON line per seed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def control_gaps(bench: dict, workload: str, seed: int, traffic=None,
                 workers: int = 0) -> list:
    """The control's gap of each voice the check compares."""
    from bench_torch.core import check, harness
    from bench_torch.core.patchdesc import PatchDesc, load_json
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    desc = PatchDesc.load(cell["config"])
    traffic = traffic or load_json("traffic", cell["traffic"])
    driver = harness.load_file("drivers", traffic["driver"])
    items = driver.checked_items(desc, traffic, seed,
                                 float(bench["run_seconds"]))
    return check.reference_gaps(cell["config"], items, prec="bf16",
                                workers=workers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from bench_torch.core import harness
    bench = harness.load_bench()
    for seed in args.seeds:
        t = time.perf_counter()
        gaps = control_gaps(bench, args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_audio_gap": max(gaps),
                          "control_gap_least": min(gaps),
                          "voices": len(gaps),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
