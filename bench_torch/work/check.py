"""The CPU check of the frozen work tables (run by ``rehearse.py``).

At the commit the tables were frozen at, they equal the program's own
counts (``srack_tpu_torch.ops.partition.module_ops`` and ``adjoint_ops``)
for every module of the configurations, and the roofline arithmetic gives
the bounds PERF.md's kernel table holds: 1.306 ms for K1 on the headline
(1,024 x 480,000), 0.1306 and 0.3345 ms for K10's forward and backward
(1,024 x 48,000), 1.306 ms for K3 and 1.828 ms for K8 on the reverb.
Returns a list of failures (empty when all hold).
"""

from __future__ import annotations

from bench_torch.core.patchdesc import PatchDesc
from bench_torch.work import roofline

BOUNDS = [  # (config, what, voices, samples, PERF.md's ms, its digits)
    ("subtractive_voice", "fused", 1024, 480000, 1.306, 3),
    ("subtractive_voice", "vjp_fwd", 1024, 48000, 0.1306, 4),
    ("subtractive_voice", "vjp_bwd", 1024, 48000, 0.3345, 4),
    ("reverb_patch", "stage", 1024, 480000, 1.306, 3),
    ("reverb_patch", "freeverb", 1024, 480000, 1.828, 3),
]


def work_of(desc, what, v, n):
    if what == "fused":
        return roofline.fused_work(desc, v, n)
    if what == "stage":
        return roofline.stage_work(desc, v, n)
    if what == "freeverb":
        verb = next(m for m in desc.modules if m["type"] == "Freeverb")
        return roofline.freeverb_work(desc, verb, v, n)
    return roofline.vjp_work(desc, v, n, what[len("vjp_"):])


def run() -> list:
    import srack_tpu_torch as stt
    from srack_tpu_torch.ops import partition
    bad = []
    for name in ("subtractive_voice", "reverb_patch"):
        desc = PatchDesc.load(name)
        patch, ids = desc.build(stt)
        compiled = stt.compile_patch(patch)
        for m in roofline.stage_modules(desc):
            mid = ids[m["name"]]
            for ours, theirs in ((roofline.step_ops, partition.module_ops),
                                 (roofline.adjoint_ops,
                                  partition.adjoint_ops)):
                a, b = ours(desc, m), theirs(compiled, mid)
                if a != b:
                    bad.append(f"{name} {m['name']} {ours.__name__}: "
                               f"table {a}, program {b}")
        out = {"type": "Output", "name": "output"}
        a = roofline.adjoint_ops(desc, out)
        b = partition.adjoint_ops(compiled, ids["output"])
        if a != b:
            bad.append(f"{name} output adjoint_ops: table {a}, program {b}")
    for name, what, v, n, want, digits in BOUNDS:
        ms, _ = roofline.bound_ms(*work_of(PatchDesc.load(name), what, v, n))
        if round(ms, digits) != want:
            bad.append(f"{name} {what} bound {ms} ms, PERF.md {want}")
    return bad
