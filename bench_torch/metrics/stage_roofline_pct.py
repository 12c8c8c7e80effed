"""K3's share of its roofline: one serial-stage run's bound (the steps of
the modules with a device function; the wires that leave the stage) over
the stage kernel's (``srk_fused_kernel``, the fused kernel's source in its
stage mode) device time per render."""

from bench_torch.metrics._share import kernel_share
from bench_torch.work import roofline


def read(r):
    work = roofline.stage_work(r.desc, r.counts["voices"], r.counts["n"])
    return kernel_share(r, lambda name: "srk_fused_kernel" in name, work)
