"""Driver of ``render_batch``: a render farm in a closed loop.

Set-up draws a pool of ``param_batches`` batches of ``voices`` voices from
the mix's ``pool_seed``, puts them on the device and renders and checks
one batch once (the cell's one shape: every kernel built and loaded).  The window
renders ``n`` samples of every voice, batch after batch in an order drawn
from the run's seed, each render ending in a synchronise, until
``--seconds`` have passed.  The params change a render's time by a few
per cent (the kernels' branches), so every seed renders the same pool:
the seed orders it and picks the voices the check compares.

``samples_per_s`` (G samples/s) is voices x samples of every render
completed, over the host seconds from the window's start to the end of
the last render.  The check: ``check_voices_per_batch`` voices of each
batch, drawn from the seed, of the window's first render of that batch go
to the reference, each with its row in the render.  Every later render of
a batch is held to its first: the checked voices sample for sample, and
every voice by the sums of its samples' bit patterns over 64 stretches of
its audio (``renders_differing`` counts the renders that differ in
either).  That check runs on the device after each render has finished,
in a ``check`` span, so a trace tells its kernels from the program's; the
window's time includes it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_torch.core.check import Item, rows_in
from bench_torch.core.harness import Run
from bench_torch.core.patchdesc import (PARAM_RULES, program_params,
                                        sub_seed, voices_of)

STRETCHES = 64


def draw(desc, tr, seed: int):
    """The pool's batches in the seed's order and, for each, the voices
    the check compares."""
    v, n_b = int(tr["voices"]), int(tr["param_batches"])
    rule = PARAM_RULES[tr["params"]]
    rng = np.random.default_rng(sub_seed(seed, 2))
    order = rng.permutation(n_b)
    batches = [rule(desc, v, sub_seed(tr["pool_seed"], 1, int(b)))
               for b in order]
    k = int(tr["check_voices_per_batch"])
    picks = [sorted(int(j) for j in rng.choice(v, k, replace=False))
             for _ in range(n_b)]
    return batches, picks


def checked_items(desc, tr, seed: int, seconds: float) -> list:
    """The voices that the check compares, a :class:`Item` with no audio
    for each batch: their params, length and rows in the render."""
    batches, picks = draw(desc, tr, seed)
    return [Item(voices_of(p, js), int(tr["n"]), None,
                 rows_in(js, int(tr["voices"])))
            for p, js in zip(batches, picks)]


def checked(desc, tr, seed: int, seconds: float) -> list:
    """``(params, n)`` of each batch's voices that the check compares."""
    return [(it.params, it.n)
            for it in checked_items(desc, tr, seed, seconds)]


def stretch_sums(audio: torch.Tensor) -> torch.Tensor:
    """Per voice, the int32 sums (mod 2^32) of its samples' bit patterns
    over ``STRETCHES`` equal stretches of its audio (fewer where they do
    not divide it): any one sample changed, or a voice shifted in time,
    changes them."""
    bits = audio.reshape(audio.shape[0], -1).view(torch.int32)
    s = next(k for k in range(STRETCHES, 0, -1) if bits.shape[1] % k == 0)
    return bits.reshape(bits.shape[0], s, -1).sum(-1, dtype=torch.int32)


def run(ctx) -> Run:
    stt, desc, tr, dev = ctx.stt, ctx.desc, ctx.traffic, ctx.device
    patch, ids = desc.build(stt)
    v, n, n_b = int(tr["voices"]), int(tr["n"]), int(tr["param_batches"])
    batches, picks = draw(desc, tr, ctx.seed)
    progs = [program_params(p, ids, patch, dev) for p in batches]
    ctx.mark("params on the device")
    picks = [torch.tensor(js, device=dev) for js in picks]

    audio, _, _ = stt.render_batch(patch, n, params=progs[0], device=dev)
    rows, sums = audio.index_select(0, picks[0]), stretch_sums(audio)
    del audio
    bool((rows != rows).any() | (sums != sums).any())
    del rows, sums
    ctx.setup_done()

    first = [None] * n_b
    differing = torch.zeros((), dtype=torch.int64, device=dev)
    renders = 0
    with ctx.window():
        start = time.perf_counter()
        while True:
            b = renders % n_b
            with ctx.span("render"):
                audio, _, _ = stt.render_batch(patch, n, params=progs[b],
                                               device=dev)
                ctx.sync()
            with ctx.span("check"):
                rows = audio.index_select(0, picks[b])
                sums = stretch_sums(audio)
                del audio
                if first[b] is None:
                    first[b] = (rows, sums)
                else:
                    differing += ((rows != first[b][0]).any()
                                  | (sums != first[b][1]).any())
                ctx.sync()
            renders += 1
            end = time.perf_counter()
            if end - start >= ctx.seconds:
                break
    items = [Item(voices_of(batches[b], picks[b].tolist()), n,
                  first[b][0].cpu().numpy(), rows_in(picks[b].tolist(), v))
             for b in range(n_b) if first[b] is not None]
    return Run(metrics={"samples_per_s": v * n * renders / (end - start)
                        / 1e9},
               attempted=renders, failed=0, items=items,
               numbers={"renders_differing": int(differing)},
               counts={"renders": renders, "voices": v, "n": n})
