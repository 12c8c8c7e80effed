"""The work of one buffer-feedback render (K2): a fused render's, and the
feedback ring in and out.

K2 runs every module's step for every voice-sample, as K1 does
(:func:`roofline.fused_work`), and besides reads its feedback ring at the
start and writes it at the end: a block of each wire that is read a block
late.  Those wires come from the plain reference's cycle break
(``reference/feedback.py::late_wires``), not from the program.
"""

from __future__ import annotations

from bench_torch.reference.feedback import late_wires
from bench_torch.work import roofline


def ring_words(desc) -> int:
    """The ring's words a voice: a block of each wire read late."""
    return len(late_wires(desc)) * desc.block_size


def buffer_work(desc, v: int, n: int) -> tuple:
    """``(bytes, ops)`` of one K2 render of ``v`` voices x ``n`` samples."""
    nbytes, ops = roofline.fused_work(desc, v, n)
    return nbytes + 2 * 4 * v * ring_words(desc), ops
