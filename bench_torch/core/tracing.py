"""The traced window: ``torch.profiler`` over the measured window, read
back as device intervals, the benchmark's own spans and the host's ops.

Spans are ``record_function`` annotations named ``bench.<what>`` that the
drivers put around each entry call; the window itself is ``bench.window``.
Everything is read from the profiler's raw events, in its clock (ns).
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict


def merge(intervals) -> list:
    """The union of ``(start, end)`` intervals, sorted, as disjoint
    intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class TraceData:
    """What a traced window holds: ``device`` (start, end, name) of every
    kernel, copy and fill of the program, and ``own`` those of the
    benchmark's own check (the device events inside a ``bench.check``
    span, which a driver opens on an idle device and closes with a
    synchronise); ``spans`` name -> [(start, end)]; ``host`` (start, end,
    name) of the window thread's ops; ``window`` (start, end).  The
    device is busy while either runs."""

    def __init__(self, device, spans, host, window):
        checks = merge(spans.get("check", []))
        starts = [c[0] for c in checks]

        def own(s, e):
            i = bisect.bisect_right(starts, s) - 1
            return i >= 0 and e <= checks[i][1]
        self.device = sorted(d for d in device if not own(d[0], d[1]))
        self.own = sorted(d for d in device if own(d[0], d[1]))
        self.spans = spans
        self.host = sorted(host, key=lambda h: (h[0], -h[1]))
        self.window = window
        lo, hi = window
        self.busy = merge((max(s, lo), min(e, hi)) for s, e, _ in device
                          if e > lo and s < hi)
        self._ends = [m[1] for m in self.busy]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def busy_in(self, s, e) -> int:
        """Device-busy ns inside ``[s, e]``."""
        i = bisect.bisect_right(self._ends, s)
        total = 0
        while i < len(self.busy) and self.busy[i][0] < e:
            total += min(e, self.busy[i][1]) - max(s, self.busy[i][0])
            i += 1
        return total

    def kernel_ns(self, match) -> tuple:
        """``(total ns, launches)`` of the device events whose name
        ``match(name)`` accepts."""
        total, count = 0, 0
        for s, e, name in self.device:
            if match(name):
                total += e - s
                count += 1
        return total, count

    def gaps(self) -> list:
        """The idle intervals of the device inside the window."""
        lo, hi = self.window
        out, t = [], lo
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time (the benchmark's own as one),
        and the idle time by what the host was doing (the innermost op of
        the window's thread at the middle of each gap), each ``[name,
        seconds]``."""
        ops = defaultdict(int)
        for s, e, name in self.device:
            ops[name] += e - s
        for s, e, _ in self.own:
            ops["bench.check (the benchmark's own)"] += e - s
        idle = defaultdict(int)
        for (s, e), label in zip(self.gaps(), self._label_gaps()):
            idle[label] += e - s

        def top_of(d):
            return [[k[:120], v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": top_of(ops), "idle_gaps": top_of(idle)}

    def _label_gaps(self) -> list:
        mids = [(s + e) // 2 for s, e in self.gaps()]
        labels, stack, j = [], [], 0
        for m in mids:
            while j < len(self.host) and self.host[j][0] <= m:
                h = self.host[j]
                while stack and stack[-1][1] < h[0]:
                    stack.pop()
                stack.append(h)
                j += 1
            while stack and stack[-1][1] < m:
                stack.pop()
            labels.append(stack[-1][2] if stack else "(no host op)")
        return labels


@contextlib.contextmanager
def span(name: str, enabled: bool):
    """A ``bench.<name>`` annotation while tracing, nothing otherwise."""
    if not enabled:
        yield
        return
    import torch
    with torch.profiler.record_function(f"bench.{name}"):
        yield


class Tracer:
    """Profiles the window when enabled; ``data`` is its
    :class:`TraceData` once the window has closed."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.data = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with torch.profiler.record_function("bench.window"):
                yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        self.data = read_events(prof)


def read_events(prof) -> TraceData:
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    spans = defaultdict(list)
    window, window_thread = None, None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns()
        end = s + e.duration_ns()
        kind = getattr(e, "activity_type", "")
        kind = str(kind() if callable(kind) else kind)
        if e.device_type() == cuda:
            if name.startswith("bench.") or "user_annotation" in kind:
                continue
            device.append((s, end, name))
            continue
        if name == "bench.window":
            window, window_thread = (s, end), e.start_thread_id()
        elif name.startswith("bench."):
            spans[name[len("bench."):]].append((s, end))
        host.append((s, end, name, e.start_thread_id()))
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    host = [(s, e, n) for s, e, n, t in host
            if t == window_thread and n != "bench.window"]
    return TraceData(device, dict(spans), host, window)
