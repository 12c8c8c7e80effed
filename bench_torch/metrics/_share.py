"""Shared arithmetic of the per-layer readers."""

from bench_torch.work import roofline


def kernel_share(r, match, work) -> float | None:
    """The roofline share, in %, of the kernels whose names ``match``
    accepts: the bound of one render's call (``work`` -> ``(bytes, ops)``)
    times the renders of the window, over those kernels' device time in
    the trace.  None where the trace holds no such kernel."""
    ns, launches = r.trace.kernel_ns(match)
    if not launches or not r.counts.get("renders"):
        return None
    ms, _ = roofline.bound_ms(*work)
    return 100.0 * ms * r.counts["renders"] / (ns / 1e6)


def idle_pct(r) -> float | None:
    """The device's idle share of the traced window, in %."""
    if r.trace.window_s <= 0 or not r.trace.device:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
