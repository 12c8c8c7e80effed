"""The device's idle share of the traced window, in %: the window less the
union of every kernel, copy and fill in it."""

from bench_torch.metrics._share import idle_pct


def read(r):
    return idle_pct(r)
