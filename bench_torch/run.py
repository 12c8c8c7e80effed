"""The benchmark of srack_tpu_torch, the PyTorch and CUDA port.

    python3 bench_torch/run.py --workload <name> --seed <n>
        --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the CUDA card of this machine (it
exits with 2 and prints no result without one): set-up, a window of
``--seconds`` seconds, then the check of what the window produced against
the plain reference.  The last line of standard output is the result as
one JSON object; the last lines of standard error are the compared
numbers, each beside its limit.  ``--trace 1`` profiles the window and
reports the per-layer metrics instead of the end-to-end ones.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = REPO / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "nv_cache"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    from bench_torch.core import harness
    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
