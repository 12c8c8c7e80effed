"""K1's share of its roofline: one fused render's bound (every module's
step, from the description) over K1's (``srk_fused_kernel``) device time
per render."""

from bench_torch.metrics._share import kernel_share
from bench_torch.work import roofline


def read(r):
    work = roofline.fused_work(r.desc, r.counts["voices"], r.counts["n"])
    return kernel_share(r, lambda name: "srk_fused_kernel" in name, work)
