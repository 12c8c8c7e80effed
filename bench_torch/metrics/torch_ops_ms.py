"""Device ms per render in kernels, copies and fills that are not the
port's own (whose names start ``srk_``): the block engine's and the
wrappers' PyTorch glue."""


def read(r):
    renders = r.counts.get("renders")
    if not renders or not r.trace.device:
        return None
    ns, _ = r.trace.kernel_ns(lambda name: "srk_" not in name)
    return ns / 1e6 / renders
