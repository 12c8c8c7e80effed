"""Shared arithmetic of the readers of the program's own spans.

The port opens ``record_function`` ranges named ``srk.<what>`` along its
render path (``srack_tpu_torch/utils/profiling.py``).  A reader charges to
a layer the device-idle time of the traced window that falls inside that
layer's spans on the window's thread: the host was running that layer's
Python while the card waited.
"""

from bench_torch.core.tracing import merge


def spans_of(r, names) -> list:
    """The union of the window thread's spans named in ``names``, as
    disjoint ``[start, end]`` intervals."""
    return merge((s, e) for s, e, name in r.trace.host if name in names)


def minus(a, b) -> list:
    """The parts of the disjoint sorted intervals ``a`` outside those of
    ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def overlap_ns(a, b) -> int:
    """The length of the intersection of two lists of disjoint sorted
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms(r, inside, outside=()) -> float | None:
    """Device-idle ms per render of the window inside a span named in
    ``inside`` and outside every span named in ``outside``.  None where
    the trace holds no span named in ``inside`` (a program without these
    spans), or no render."""
    renders = r.counts.get("renders")
    within = spans_of(r, inside)
    if not renders or not within:
        return None
    charged = minus(within, spans_of(r, outside))
    return overlap_ns(r.trace.gaps(), charged) / 1e6 / renders
