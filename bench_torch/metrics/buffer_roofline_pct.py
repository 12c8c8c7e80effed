"""K2's share of its roofline: one buffer-feedback render's bound (every
module's step, the feedback ring in and out; ``work/buffer.py``) over K2's
(``srk_fused_kernel``, the fused kernel's source in buffer mode) device
time per render.  None for a configuration outside buffer mode."""

from bench_torch.metrics._share import kernel_share
from bench_torch.work.buffer import buffer_work


def read(r):
    if not r.desc.audio.get("buffer_feedback"):
        return None
    work = buffer_work(r.desc, r.counts["voices"], r.counts["n"])
    return kernel_share(r, lambda name: "srk_fused_kernel" in name, work)
