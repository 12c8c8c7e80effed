"""Device-idle ms per render while the host runs the port's entry layer:
inside a ``srk.plan`` span (``compile_patch``) or a ``srk.render`` span
(``CompiledPatch.render``: params and state to the device, the lanes, the
kernel wrappers' packing, launches and final state) of the window's
thread, and outside every ``srk.block.run`` span (the block engine's,
read by ``block_idle_ms``)."""

from bench_torch.metrics._spans import idle_ms


def read(r):
    return idle_ms(r, ("srk.plan", "srk.render"), ("srk.block.run",))
