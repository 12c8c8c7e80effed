"""K8's share of its roofline: one Freeverb render's bound (its lanes, its
24 lines and 16 filter states in and out) over the device time per render
of K8's kernels (``srk_fv_*``)."""

from bench_torch.metrics._share import kernel_share
from bench_torch.work import roofline


def read(r):
    verbs = [m for m in r.desc.modules if m["type"] == "Freeverb"]
    if len(verbs) != 1:
        return None
    work = roofline.freeverb_work(r.desc, verbs[0], r.counts["voices"],
                                  r.counts["n"])
    return kernel_share(r, lambda name: "srk_fv_" in name, work)
