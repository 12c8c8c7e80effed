"""The port's farm across two OS processes over gloo (the twin of
``tests/test_distributed.py``).

Two real processes, each adding 4 ``cpu`` slots to an 8-slot world mesh,
are wired through ``parallel.init_distributed``; the cross-process mix bus
(one ``all_reduce``), each rank's own voices and a sharded training step
are checked in each (``tests/torch_distributed_worker.py``).  Each process
has 120 s and is killed when it runs over.
"""

import pathlib
import socket
import subprocess
import sys

WORKER = pathlib.Path(__file__).parent / "torch_distributed_worker.py"
LIMIT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_farm():
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(rank), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)
    ]
    outs = []
    try:
        for pr in procs:
            out, _ = pr.communicate(timeout=LIMIT_S)
            outs.append(out)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for rank, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"worker {rank} failed:\n{out[-4000:]}"
        assert f"[p{rank}] OK" in out
