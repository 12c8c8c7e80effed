"""The plan of a fused kernel cut into pipeline stages.

Kernels K1 (``fused_voice``), K2 (``fused_voice_buffer``), K3
(``serial_stage``) and K10's forward (``fused_vjp_fwd``) run a plan's
modules in a CTA of ``G`` stage warps (``ops/fused.py``): warp ``g`` runs
the modules of stage ``g`` for the CTA's 32 voices, one chunk of samples
behind warp ``g - 1``, and the wires between stages pass through
shared-memory rings.  K10's backward (``fused_vjp_bwd``) runs the same
cut in reverse, the last stage leading, with the wires' cotangents in the
rings.  :func:`partition` chooses the stages.

The rules:

* a stage is a run of consecutive modules of the plan, so every
  within-sample wire goes from a stage to the same or a later one;
* a feedback carry's source and sink share a stage: no cut falls between
  a carried read and its source (in sample mode; in buffer mode K2 reads
  its delayed wires from its ring and a stage from lanes, and neither
  carries anything);
* the stages minimise the costliest stage's operations per sample
  (:func:`module_ops`; K10's backward weighs each module by
  :func:`sweep_ops`, its step's re-run plus its adjoint), then the number
  of cross-stage wires (each one a shared-memory ring), then the number of
  stages;
* at most :data:`MAX_STAGES` stages, one warp for each of an SM's four
  schedulers.

A dynamic programme over the plan order finds the optimum among such
cuts; the presets have at most 32 modules.
"""

from __future__ import annotations

import dataclasses

MAX_STAGES = 4


# Operations per sample of each device function of csrc/modules.cuh, read
# off its source: one each add, sub, mul, div, compare, select, min/max,
# abs, negation and int<->float conversion, on the path a sample takes (f32
# but for the exact Oscillator's f64 ones, :func:`module_ops_f64`).  The partition weighs its stages by them, and the kernels' bounds
# count them.
def module_ops(compiled, mid) -> int:
    mdef, statics, inputs = compiled.instances[mid]
    t = mdef.type_name
    conn = [c is not None for c in inputs]
    auto = mid in compiled._auto_by_mid
    if t == "Oscillator" and compiled.cfg.exact:
        return module_ops_f64(compiled, mid) + (2 if conn[1] else 0) + (
            6 if statics[1] else 4)                 # sync; square, saw
    if t == "Oscillator":
        ops = 15 + (2 if conn[1] else 0)           # core, sync
        if statics[1]:
            ops += 22                               # polyBLEP square, saw
        if conn[0] or auto:
            ops += 30                               # exp2 pitch, fixed
        return ops
    if t == "Moog Filter":
        return 35 + (17 if conn[1] or auto else 0) + (2 if auto else 0)
    if t == "ADSR":
        return 20 + (6 if auto else 0)
    if t == "VCA":
        return 0 if not all(conn) else (1 if statics[1] else 3)
    if t == "Mono Mixer":
        return 2 * sum(conn)
    if t in ("Add", "Subtract", "Multiply"):
        return 1
    if t == "Non-Linear":
        return 23                                   # powf, sign fold
    if t == "Grid Sequencer":
        return 8
    if t == "Pattern Sequencer":
        return 19
    return 0                                        # Input, Noise, Output


# The f64 operations per sample among them: the exact Oscillator's
# (``srk_osc_exact``), whose phase, increment and waves are doubles.  The
# libdevice calls are counted by their instructions on the path a phase in
# [0, 1) takes: sin (range reduction and its polynomial) 30, exp2 25.
# chip_smoke.py's bounds divide these by the card's f64 peak.
def module_ops_f64(compiled, mid) -> int:
    mdef, statics, inputs = compiled.instances[mid]
    if mdef.type_name != "Oscillator" or not compiled.cfg.exact:
        return 0
    ops = 8 + 30                # reset, add, floor-mod wrap; sin(2 pi pos)
    if statics[1]:
        ops += 2 * 9 + 4 + 3    # two polyBLEPs, the half-phase wrap, casts
    if inputs[0] is not None or mid in compiled._auto_by_mid:
        ops += 5 + 25           # the pitch: casts, add, exp2, mul, div
    return ops


# f32 operations per sample of each adjoint of csrc/modules_adj.cuh on the
# path a sample takes, counted as module_ops counts the steps, but only the
# derivative's own: the primal values an adjoint recomputes (the phase in
# turns, the ladder's stages, exp2's polynomial, the envelope's selects) are
# the step's, which module_ops counts.  A clip's derivative with JAX's tie
# rule counts 6.  K10's backward partition weighs its stages by them, and
# its bound counts them.
def adjoint_ops(compiled, mid) -> int:
    mdef, statics, inputs = compiled.instances[mid]
    t = mdef.type_name
    conn = [c is not None for c in inputs]
    auto = mid in compiled._auto_by_mid
    if t == "Oscillator":
        ops = 17 + (1 if conn[1] else 0)           # sinpi', shadow phase
        if statics[1]:
            ops += 30                               # both polyBLEP VJPs
        if conn[0] or auto:
            ops += 25                               # exp2'
        return ops
    if t == "Moog Filter":                          # ladder, 5 clips'
        return 102 + (37 if conn[1] or auto else 0) + (8 if auto else 0)
    if t == "ADSR":
        return 27 + (15 if auto else 0)
    if t == "VCA":
        return 0 if not all(conn) else 5
    if t == "Mono Mixer":
        return 4 * sum(conn)
    if t == "Multiply":
        return 4
    if t in ("Add", "Subtract"):
        return 2
    if t == "Non-Linear":
        return 60                                   # 3 powf, 2 logf
    if t == "Grid Sequencer":
        return 8
    if t == "Pattern Sequencer":
        return 4                                    # one add per row
    if t == "Output":
        return 4 * sum(conn)                        # nan_to_num, add
    if t == "Input":
        return 1
    return 0                                        # Noise


def sweep_ops(compiled, mid) -> int:
    """A module's operations per sample in K10's backward sweep: its step,
    re-run for the wires its adjoint needs, plus its adjoint."""
    return module_ops(compiled, mid) + adjoint_ops(compiled, mid)


@dataclasses.dataclass(frozen=True)
class Partition:
    """Stages of one plan: ``stages[g]`` the module ids of stage ``g`` in
    plan order, ``costs[g]`` their operations per sample, and ``wires``
    the cross-stage wires ``((src, port), producer stage, last consumer
    stage)`` in sorted order."""
    stages: tuple
    costs: tuple
    wires: tuple

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def stage_of(self) -> dict:
        return {mid: g for g, mods in enumerate(self.stages) for mid in mods}

    def describe(self) -> str:
        return " | ".join(f"{len(m)} modules, {c} ops"
                          for m, c in zip(self.stages, self.costs))


def one_stage(compiled, plan=None, cost=module_ops) -> Partition:
    """The whole plan as one stage: the one-thread kernel."""
    plan = list(compiled.plan if plan is None else plan)
    return Partition((tuple(plan),),
                     (sum(cost(compiled, m) for m in plan),), ())


def _edges(compiled, plan, carried: bool):
    """Within-sample reads ``(src pos, sink pos, (src, port))`` and the
    spans ``(sink pos, src pos)`` that a carried feedback read forbids a
    cut in."""
    pos = {mid: i for i, mid in enumerate(plan)}
    reads, spans = [], []
    for mid in plan:
        for c in compiled.instances[mid][2]:
            if c is None or c[0] not in pos:
                continue   # unconnected, or a stage input lane
            if compiled.plan_pos[c[0]] >= compiled.plan_pos[mid]:
                if carried:
                    spans.append((pos[mid], pos[c[0]]))
            else:
                reads.append((pos[c[0]], pos[mid], c))
    return reads, spans


def partition(compiled, plan=None, carried: bool = True,
              max_stages: int = MAX_STAGES, cost=module_ops) -> Partition:
    """The stages of ``plan`` (the whole plan by default, or a serial
    stage's); ``carried``: feedback reads are carries (sample mode) rather
    than lanes (a buffer-mode stage); ``cost(compiled, mid)``: a module's
    operations per sample (K10's backward: :func:`sweep_ops`)."""
    plan = list(compiled.plan if plan is None else plan)
    m = len(plan)
    if m == 0 or max_stages <= 1:
        return one_stage(compiled, plan, cost)
    cost = [cost(compiled, mid) for mid in plan]
    prefix = [0]
    for c in cost:
        prefix.append(prefix[-1] + c)
    reads, spans = _edges(compiled, plan, carried)
    # a cut at j puts positions < j and >= j in different stages
    cut_ok = [True] * (m + 1)
    for lo, hi in spans:
        for j in range(lo + 1, hi + 1):
            cut_ok[j] = False

    def out_wires(i, j):
        """Wires leaving the segment [i, j)."""
        return len({w for s, d, w in reads if i <= s < j and d >= j})

    inf = float("inf")
    # best[k][j]: the least costliest stage over k segments of [0, j)
    best = [[inf] * (m + 1) for _ in range(max_stages + 1)]
    best[0][0] = 0
    for k in range(1, max_stages + 1):
        for j in range(1, m + 1):
            if j < m and not cut_ok[j]:
                continue
            for i in range(j):
                if best[k - 1][i] < inf and (i == 0 or cut_ok[i]):
                    best[k][j] = min(best[k][j], max(
                        best[k - 1][i], prefix[j] - prefix[i]))
    bound = min(best[k][m] for k in range(1, max_stages + 1))
    # among cuts with every stage within the bound: fewest wires
    wires = [[(inf, None)] * (m + 1) for _ in range(max_stages + 1)]
    wires[0][0] = (0, None)
    for k in range(1, max_stages + 1):
        for j in range(1, m + 1):
            if j < m and not cut_ok[j]:
                continue
            for i in range(j):
                w0 = wires[k - 1][i][0]
                if (w0 < inf and prefix[j] - prefix[i] <= bound
                        and (i == 0 or cut_ok[i])):
                    w = w0 + out_wires(i, j)
                    if w < wires[k][j][0]:
                        wires[k][j] = (w, i)
    k = min(range(1, max_stages + 1), key=lambda k: (wires[k][m][0], k))
    cuts, j = [], m
    while k:
        i = wires[k][j][1]
        cuts.append((i, j))
        j, k = i, k - 1
    cuts.reverse()
    stages = tuple(tuple(plan[i:j]) for i, j in cuts)
    stage_at = [g for g, (i, j) in enumerate(cuts) for _ in range(i, j)]
    last = {}
    for s, d, w in reads:
        if stage_at[d] > stage_at[s]:
            last[w] = max(last.get(w, 0), stage_at[d])
    cross = tuple(sorted((w, stage_at[plan.index(w[0])], g)
                         for w, g in last.items()))
    return Partition(stages, tuple(prefix[j] - prefix[i] for i, j in cuts),
                     cross)
