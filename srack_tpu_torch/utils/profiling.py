"""Profiling and render statistics (counterpart:
``srack_tpu/utils/profiling.py``).

Wall time and throughput per render (:func:`timed_render`: CUDA events on
the card, the host clock on the CPU), a ``torch.profiler`` trace around
a region (:func:`trace`), and the port's own spans (:func:`span`).

The render path opens a span at each layer boundary, named ``srk.<what>``:
``srk.plan`` (``compile_patch``; ``srk.plan.build`` on a cache miss),
``srk.render`` (``CompiledPatch.render``) holding ``srk.state`` (params
and initial state on the device) and ``srk.lanes`` (``_make_xs``), the
kernel wrappers' ``srk.pack`` (operands and outputs), ``srk.launch`` (one
a ``CudaLib.launch``) and ``srk.finish`` (the final state), in buffer mode
``srk.ring`` inside the first and the last (K2's feedback ring packed
from the state and unpacked into the final state), the block
engine's ``srk.block.run`` holding ``srk.block.pre``, ``.stage`` and
``.post`` and in the block phases one ``srk.block.<module type>`` a module,
and the builds' ``srk.build.nvcc`` and ``srk.build.load``.  A span nests in
the one open around it on its thread.  Spans cost one flag test when no
profiler records; under one they are host ops on the clock of the
device's events, so a trace charges each idle gap of the card to the layer
whose Python the host was running.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A range named ``name`` while a ``torch.profiler`` records, else a
    context that does nothing (one flag test).

    The range is a plain host op (``_RecordFunctionFast``), not a
    ``record_function`` user annotation: the profiler mirrors each user
    annotation onto the device's timeline as an event spanning the kernels
    launched inside it, and a reader of device events would count those
    spans as device work."""
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF


@dataclasses.dataclass
class RenderStats:
    """Per-render statistics."""
    n_samples: int
    n_voices: int
    channels: int
    sample_rate: int
    wall_s: float
    compile_s: float = 0.0
    peak_amplitude: float = 0.0
    rms: float = 0.0
    nan_lanes: int = 0

    @property
    def samples_per_sec(self) -> float:
        return self.n_samples * self.n_voices / self.wall_s

    @property
    def realtime_factor(self) -> float:
        """Aggregate real-time factor across all voices."""
        return self.samples_per_sec / self.sample_rate

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["samples_per_sec"] = self.samples_per_sec
        d["realtime_factor"] = self.realtime_factor
        return d


def timed_render(compiled, n_samples: int, *, warmup: bool = True,
                 **kwargs):
    """Render with timing and signal statistics.  Returns ``(audio,
    probes, state, RenderStats)``.  ``kwargs`` go to
    ``CompiledPatch.render``.  On a CUDA device ``wall_s`` is the device
    time between CUDA events around the render; on the CPU the host clock.
    ``compile_s`` is the warm-up render's time (kernel builds included)."""
    # imported here: the compiler imports this module for its spans
    from ..compiler import resolve_device
    device = resolve_device(kwargs.pop("device", None))
    t0 = time.perf_counter()
    if warmup:
        compiled.render(n_samples, device=device, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    compile_s = time.perf_counter() - t0

    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        audio, probes, state = compiled.render(n_samples, device=device,
                                               **kwargs)
        end.record()
        end.synchronize()
        wall = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        audio, probes, state = compiled.render(n_samples, device=device,
                                               **kwargs)
        wall = time.perf_counter() - t0

    a = audio.detach()
    batched = a.dim() == 3
    stats = RenderStats(
        n_samples=n_samples,
        n_voices=a.shape[0] if batched else 1,
        channels=a.shape[-2],
        sample_rate=compiled.cfg.sample_rate,
        wall_s=wall,
        compile_s=compile_s,
        peak_amplitude=float(a.abs().max()) if a.numel() else 0.0,
        rms=(float(a.square().mean(dtype=torch.float64).sqrt())
             if a.numel() else 0.0),
        nan_lanes=int((~torch.isfinite(a)).any(dim=-1).sum()),
    )
    return audio, probes, state, stats


@contextlib.contextmanager
def trace(name: str, trace_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the block (CPU and, with a card, CUDA
    activity) inside a ``record_function(name)`` span; yields the
    profiler, whose ``key_averages()`` sums the ops by name.  With
    ``trace_dir`` the Chrome trace is written to ``trace_dir/name.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(name):
            yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
