"""Deciding ``correct``: what the timed path produced, against the plain
reference, each compared number beside its limit.

A driver hands over :class:`Item` s (a group of voices' params, the
length, the audio the program produced for them, where each voice sat in
its render) and numbers of its own (e.g. renders that disagreed with the
first render of their params).  The plain reference that the
configuration names (``reference/<reference>.py``) renders the voices in
a few worker processes (numpy and torch on the CPU, the recurrences one
sample at a time over all of a worker's voices), after the window has
closed and the program's state is freed.
Each worker is this module run as a program (``python -m
bench_torch.core.check``): its job comes pickled on standard input, its
gaps go back pickled on standard output, and every worker has ended
before :func:`reference_gaps` returns or raises.

No process of a run may hold JAX or the JAX package (:data:`FOREIGN`):
the harness looks once the window has closed and again before its line,
and each worker before it hands back its gaps.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import pickle
import subprocess
import sys

import numpy as np

from .patchdesc import ROOT, voices_of

# top-level module names that no process of a run may hold, compared
# whole: the port's name, srack_tpu_torch, begins with the JAX package's
FOREIGN = frozenset({"jax", "jaxlib", "flax", "srack_tpu"})
FOREIGN_EXIT = 3  # a worker's exit code when it holds one


class ForeignModules(RuntimeError):
    """A process of the run loaded JAX or the JAX package."""


def foreign_modules(names=None) -> list:
    """The names of :data:`FOREIGN` among the top-level names of
    ``names`` (``sys.modules`` by default)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.partition(".")[0] for m in names} & FOREIGN)


def refuse_foreign(where: str) -> None:
    """Raises :class:`ForeignModules`, naming what it found, if this
    process holds a module of :data:`FOREIGN`."""
    found = foreign_modules()
    if found:
        raise ForeignModules(f"{where}: sys.modules holds "
                             f"{', '.join(found)}")


@dataclasses.dataclass
class Item:
    """Voices the program rendered in the window: their params ``{module:
    {param: [v] array}}``, their length, their ``[v, channels, n]`` audio,
    and where each sat in its render (:func:`rows_in`)."""
    params: dict
    n: int
    audio: np.ndarray
    voices: dict | None = None


def rows_in(rows, render_voices: int) -> dict:
    """``Item.voices`` of the voices at ``rows`` of a render of
    ``render_voices`` voices: ``{"row": [v], "render_voices": [v]}``
    int64 arrays."""
    rows = np.asarray(rows, dtype=np.int64)
    return {"row": rows,
            "render_voices": np.full(len(rows), render_voices, np.int64)}


def gap(program: np.ndarray, reference: np.ndarray) -> float:
    """The widest distance between the program's samples and the
    reference's; infinite where the program's are not finite."""
    d = np.abs(program.astype(np.float64) - reference.astype(np.float64))
    if not np.all(np.isfinite(d)):
        return math.inf
    return float(d.max()) if d.size else 0.0


def _reference_gaps(config: str, params: dict, n: int, audio, prec: str,
                    voices):
    import torch
    torch.set_num_threads(1)
    from .patchdesc import PatchDesc
    desc = PatchDesc.load(config)
    ref = importlib.import_module(f"bench_torch.reference.{desc.reference}")
    if audio is None:
        audio = ref.render(desc, params, n, prec, voices)
        prec = "f32"
    out = ref.render(desc, params, n, prec, voices)
    return [gap(a, r) for a, r in zip(audio, out)]


def reference_gaps(config: str, items: list, prec: str = "f32",
                   workers: int = 0) -> list:
    """The gap of each voice of the items against the reference that the
    configuration ``config`` names, in the items' order.  The voices (of one length) are spread evenly over
    worker processes, each with its params and its row, half as many as
    there are CPUs by default: a worker's time goes to the recurrences'
    per-sample steps whatever its voices, and more workers than that ran
    no faster on the card's host.  Items with no audio are the control:
    the reference computed in ``prec`` in the program's place, against the
    reference in f32.  Raises :class:`ForeignModules` if a worker loaded
    a module of :data:`FOREIGN`."""
    if not items:
        return []
    n = items[0].n
    if any(it.n != n for it in items):
        raise ValueError("the items' voices differ in length")
    params = {m: {k: np.concatenate([it.params[m][k] for it in items])
                  for k in pd} for m, pd in items[0].params.items()}
    audio = (None if items[0].audio is None
             else np.concatenate([it.audio for it in items]))
    voices = (None if items[0].voices is None
              else {k: np.concatenate([it.voices[k] for it in items])
                    for k in items[0].voices})
    v = len(next(a for pd in params.values() for a in pd.values()))
    workers = workers or max(1, (os.cpu_count() or 2) // 2)
    chunks = np.array_split(np.arange(v), min(workers, v))
    jobs = [(config, voices_of(params, idx), n,
             None if audio is None else audio[idx], prec,
             None if voices is None else {k: a[idx]
                                          for k, a in voices.items()})
            for idx in chunks]
    procs = []
    try:
        for _ in jobs:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "bench_torch.core.check"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                cwd=ROOT.parent))
        for p, job in zip(procs, jobs):
            pickle.dump(job, p.stdin, protocol=pickle.HIGHEST_PROTOCOL)
            p.stdin.close()
        gaps = []
        for p in procs:
            out = p.stdout.read()
            rc = p.wait()
            if rc == FOREIGN_EXIT:
                raise ForeignModules(
                    f"a reference worker of {config!r} loaded a module of "
                    f"{', '.join(sorted(FOREIGN))} (its standard error "
                    f"names it)")
            if rc != 0:
                raise RuntimeError(f"reference worker exited with {rc}")
            gaps.extend(pickle.loads(out))
        return gaps
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            for f in (p.stdin, p.stdout):
                try:
                    f.close()
                except OSError:
                    pass


def _serve() -> int:
    """A worker: one job from standard input, its gaps to standard output
    (anything else the job prints goes to standard error).  A worker that
    holds a module of :data:`FOREIGN` names it there and hands back
    nothing."""
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    job = pickle.load(sys.stdin.buffer)
    gaps = _reference_gaps(*job)
    found = foreign_modules()
    if found:
        print(f"reference worker: sys.modules holds {', '.join(found)}",
              file=sys.stderr)
        return FOREIGN_EXIT
    pickle.dump(gaps, out)
    out.close()
    return 0


def limits_for(workload: str) -> dict:
    """``limits/<workload>.json``: ``{number: limit}``."""
    path = ROOT / "limits" / f"{workload}.json"
    return {k: float(v) for k, v in json.loads(path.read_text())
            ["limits"].items()}


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: each number beside its limit; a number with no
    limit, or a limit with no number, is not correct."""
    checks = {}
    ok = set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        value = numbers.get(name, math.nan)
        limit = limits.get(name, math.nan)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, checks


if __name__ == "__main__":
    sys.exit(_serve())
