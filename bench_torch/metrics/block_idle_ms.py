"""Device-idle ms per render while the host runs the block engine: inside
a ``srk.block.run`` span (``BlockProgram.run``: its pre, stage and post
phases, each block-phase module's call and the kernel wrappers under
them) of the window's thread."""

from bench_torch.metrics._spans import idle_ms


def read(r):
    return idle_ms(r, ("srk.block.run",))
