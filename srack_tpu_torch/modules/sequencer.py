"""Grid and Pattern sequencers, per-sample steps (counterpart:
``srack_tpu/modules/sequencer.py``).

Grid Sequencer: a piano roll of up to 64 steps.  The step pointer advances
on a rising edge of the Step input, resets to 0 on a rising edge of Sync,
and wraps when it reaches ``n_steps``.  A cell is off (0), a slide note (1)
or a held note (2): a note cell emits cv = note / steps_per_octave with
gate 1.0 when held, or the Step input itself as the gate when it slides;
an empty cell holds the last CV with gate 0.  Sync out is 1.0 on step 0.

Pattern Sequencer: 8 trigger rows over the same step pointer; per row an
on cell emits 1.0, a slide cell passes the Step input through, an empty
cell emits 0.0.

The sequence is an int32 param table of a static capacity (a multiple of 8,
at most 64) with ``n_steps`` a param, so edits within the capacity reuse
the compiled plan.  ``derive`` packs the grid's notes and cells into one
table (``note * 4 + cell``) and the pattern's 8 rows into one table of
2-bit fields, so a sample reads one entry.

The whole-block forms (``_grid_block``, ``_pat_block``) run the step
pointer over ``[V, n]`` rows as a segmented prefix count (kernel K4's int32
sum and running max on CUDA tensors) and read the packed table with
``table_lookup_rows`` (kernel K5 on CUDA tensors).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import AudioConfig
from ..ops.basic import (block_lane, block_transitions, fast_cumsum,
                         forward_fill, monotone_fill, table_lookup,
                         table_lookup_rows, transition, transition_init)
from .base import CV_DTYPE, ModuleDef, const_ports, in_or

MAX_STEPS = 64
N_ROWS = 8


def _capacity(n_steps: int, requested) -> int:
    """Static table capacity: the smallest multiple of 8 (at most
    ``MAX_STEPS``) that holds the sequence."""
    cap = int(requested) if requested else 0
    cap = max(cap, int(n_steps), 1)
    return min(-(-cap // 8) * 8, MAX_STEPS)


def _i32(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.int32)


def _advance_step(state, step_in, sync_in, n_steps):
    """The shared step-pointer update: count Step edges, reset on a Sync
    edge, wrap at ``n_steps``."""
    step_last, step_fired = transition(state["step_last"], step_in)
    sync_last, sync_fired = transition(state["sync_last"], sync_in)
    cs = state["current_step"] + step_fired.to(torch.int32)
    cs = torch.where(sync_fired, 0, cs)
    cs = torch.where(cs >= n_steps, 0, cs).to(torch.int32)
    return cs, step_last, sync_last


def _advance_step_block(state, step_in, sync_in, n_steps):
    """The step pointer over ``[V, n]`` rows: with +1 increments, wrapping
    to 0 on reaching ``n_steps`` is ``mod n_steps``, and a Sync edge
    restarts the count at the last reset (a segmented prefix count; the
    carried step is below ``n_steps``, as the step keeps it).  Returns
    ``(cs [V, n], step_last, sync_last)``."""
    step_last, step_edges = block_transitions(state["step_last"], step_in)
    sync_last, sync_edges = block_transitions(state["sync_last"], sync_in)
    e_cum = fast_cumsum(step_edges.to(torch.int32))  # inclusive
    # the count at the last reset: e_cum never decreases, so the fill is a
    # running max (exact on int32)
    e_at_reset, has_reset = monotone_fill(e_cum, sync_edges)
    base = torch.where(has_reset, e_cum - e_at_reset,
                       state["current_step"].unsqueeze(-1) + e_cum)
    # floor mod, as jnp.mod; XLA's x mod 0 is x where torch raises, so a
    # sequence of 0 steps takes the per-sample step's answer, 0
    cs = torch.remainder(base, torch.clamp(n_steps, min=1).unsqueeze(-1))
    return cs.to(torch.int32), step_last, sync_last


def _block_ins(state, ins, n):
    v, device = state["current_step"].shape[0], state["current_step"].device
    return (block_lane(ins[0], v, n, device=device),
            block_lane(ins[1], v, n, device=device))


def _sync_out(cs):
    return torch.where(cs == 0, 1.0, 0.0).to(CV_DTYPE)


# ---------------------------------------------------------------------------
# Grid sequencer
# ---------------------------------------------------------------------------

def _coerce_grid_sequence(sequence, capacity):
    """``[None, (note, hold), ...]`` -> ``(notes[K], cells[K])`` int32."""
    notes = np.zeros((capacity,), dtype=np.int32)
    cells = np.zeros((capacity,), dtype=np.int32)
    if sequence is not None:
        if len(sequence) > capacity:
            raise ValueError(f"sequence longer than capacity {capacity}")
        for i, cell in enumerate(sequence):
            if cell is None:
                continue
            note, hold = cell
            notes[i] = int(note)
            cells[i] = 2 if hold else 1
    return notes, cells


def _grid_make(cfg: AudioConfig, sequence=None, n_steps: int = None,
               octaves: int = 2, steps_per_octave: int = 12,
               capacity: int = None):
    if n_steps is None:
        n_steps = len(sequence) if sequence is not None else MAX_STEPS
    cap = _capacity(max(n_steps, len(sequence) if sequence else 0), capacity)
    notes, cells = _coerce_grid_sequence(sequence, cap)
    params = {
        "notes": torch.from_numpy(notes),
        "cells": torch.from_numpy(cells),
        "n_steps": _i32(int(n_steps)),
        "steps_per_octave": _i32(int(steps_per_octave)),
    }
    return ("gridseq", int(octaves), cap), params


def _grid_derive(cfg: AudioConfig, statics, params, connected):
    """The packed table and the CV scale, once per render."""
    return {"packed_tbl": params["notes"] * 4 + params["cells"],
            "inv_spo": 1.0 / params["steps_per_octave"].to(CV_DTYPE)}


def _grid_packed(params):
    if "packed_tbl" not in params:  # a step outside a compiled render
        params = _grid_derive(None, None, params, None)
    return params["packed_tbl"], params["inv_spo"]


def _grid_init_state(cfg: AudioConfig, statics, device=None):
    return {
        "current_step": torch.zeros((), dtype=torch.int32, device=device),
        "step_last": transition_init(device),
        "sync_last": transition_init(device),
        "last_cv": torch.zeros((), dtype=CV_DTYPE, device=device),
    }


def _grid_step(cfg: AudioConfig, statics, params, state, ins, x=None):
    step_in = in_or(ins[0], 0.0, state["current_step"])
    sync_in = in_or(ins[1], 0.0, state["current_step"])
    cs, step_last, sync_last = _advance_step(state, step_in, sync_in,
                                             params["n_steps"])
    packed_tbl, inv_spo = _grid_packed(params)
    packed = table_lookup(packed_tbl, cs)
    cell = packed % 4      # floor semantics, as jnp's
    note = packed // 4
    note_cv = note.to(CV_DTYPE) * inv_spo
    on = cell > 0
    cv_out = torch.where(on, note_cv, state["last_cv"]).to(CV_DTYPE)
    gate_out = torch.where(on, torch.where(cell == 2, 1.0, step_in), 0.0)
    sync_out = _sync_out(cs)
    new_state = {
        "current_step": cs,
        "step_last": step_last,
        "sync_last": sync_last,
        "last_cv": cv_out,
    }
    return new_state, (cv_out, gate_out, sync_out)


def _grid_block(cfg: AudioConfig, statics, params, state, ins, x, n):
    step_in, sync_in = _block_ins(state, ins, n)
    cs, step_last, sync_last = _advance_step_block(
        state, step_in, sync_in, params["n_steps"])
    packed_tbl, inv_spo = _grid_packed(params)
    packed = table_lookup_rows(packed_tbl, cs)
    cell = packed & 3      # floor semantics for negative notes
    note = packed >> 2
    note_cv = note.to(CV_DTYPE) * inv_spo.unsqueeze(-1)
    on = cell > 0
    # empty cells hold the last emitted CV
    filled, any_on = forward_fill(note_cv, on)
    cv_out = torch.where(any_on, filled,
                         state["last_cv"].unsqueeze(-1)).to(CV_DTYPE)
    gate_out = torch.where(on, torch.where(cell == 2, 1.0, step_in), 0.0)
    new_state = {
        "current_step": cs[:, -1],
        "step_last": step_last,
        "sync_last": sync_last,
        "last_cv": cv_out[:, -1],
    }
    return new_state, (cv_out, gate_out, _sync_out(cs))


_grid_nin, _grid_inlabels = const_ports(2, ("Step", "Sync"))
_grid_nout, _grid_outlabels = const_ports(3, ("CV", "Gate", "Sync"))

GRID_SEQUENCER = ModuleDef(
    type_name="Grid Sequencer",
    make=_grid_make,
    num_inputs=_grid_nin,
    num_outputs=_grid_nout,
    input_labels=_grid_inlabels,
    output_labels=_grid_outlabels,
    init_state=_grid_init_state,
    step=_grid_step,
    block=_grid_block,
    derive=_grid_derive,
    cuda_fn="srk_grid_sequencer",
    cuda_adj="srk_grid_sequencer_adj",
)


# ---------------------------------------------------------------------------
# Pattern sequencer
# ---------------------------------------------------------------------------

def _coerce_pattern(pattern, capacity):
    """``[[None | True | False] * steps] * 8`` -> cells ``[8, K]``, with
    the grid's 0/1/2 encoding."""
    cells = np.zeros((N_ROWS, capacity), dtype=np.int32)
    if pattern is not None:
        if len(pattern) > N_ROWS:
            raise ValueError(f"pattern has more than {N_ROWS} rows")
        for r, row in enumerate(pattern):
            if len(row) > capacity:
                raise ValueError(f"pattern longer than capacity {capacity}")
            for i, val in enumerate(row):
                if val is None:
                    continue
                cells[r, i] = 2 if val else 1
    return cells


def _pat_make(cfg: AudioConfig, pattern=None, n_steps: int = None,
              capacity: int = None):
    max_row = max((len(r) for r in pattern), default=0) if pattern else 0
    if n_steps is None:
        n_steps = max_row if pattern else MAX_STEPS
    cap = _capacity(max(n_steps, max_row), capacity)
    params = {
        "cells": torch.from_numpy(_coerce_pattern(pattern, cap)),
        "n_steps": _i32(int(n_steps)),
    }
    return ("patseq", N_ROWS, cap), params


def _pat_packed(params):
    tbl = params.get("packed_tbl")
    if tbl is not None:
        return tbl
    cells = params["cells"]  # [..., N_ROWS, K]
    tbl = cells[..., 0, :]
    for r in range(1, N_ROWS):
        tbl = tbl + cells[..., r, :] * (4 ** r)
    return tbl


def _pat_derive(cfg: AudioConfig, statics, params, connected):
    """The 8 rows packed 2 bits each into one table, once per render."""
    return {"packed_tbl": _pat_packed(params)}


def _pat_init_state(cfg: AudioConfig, statics, device=None):
    return {
        "current_step": torch.zeros((), dtype=torch.int32, device=device),
        "step_last": transition_init(device),
        "sync_last": transition_init(device),
    }


def _pat_step(cfg: AudioConfig, statics, params, state, ins, x=None):
    step_in = in_or(ins[0], 0.0, state["current_step"])
    sync_in = in_or(ins[1], 0.0, state["current_step"])
    cs, step_last, sync_last = _advance_step(state, step_in, sync_in,
                                             params["n_steps"])
    packed = table_lookup(_pat_packed(params), cs)
    sync_out = _sync_out(cs)
    new_state = {
        "current_step": cs,
        "step_last": step_last,
        "sync_last": sync_last,
    }
    return new_state, _pat_gates(packed, step_in) + (sync_out,)


def _pat_gates(packed, step_in):
    return tuple(torch.where(col == 2, 1.0, torch.where(col == 1, step_in,
                                                           0.0))
                 for col in ((packed >> (2 * r)) & 3 for r in range(N_ROWS)))


def _pat_block(cfg: AudioConfig, statics, params, state, ins, x, n):
    step_in, sync_in = _block_ins(state, ins, n)
    cs, step_last, sync_last = _advance_step_block(
        state, step_in, sync_in, params["n_steps"])
    packed = table_lookup_rows(_pat_packed(params), cs)
    new_state = {
        "current_step": cs[:, -1],
        "step_last": step_last,
        "sync_last": sync_last,
    }
    return new_state, _pat_gates(packed, step_in) + (_sync_out(cs),)


_pat_nin, _pat_inlabels = const_ports(2, ("Step", "Sync"))
_pat_nout, _pat_outlabels = const_ports(
    N_ROWS + 1, tuple(str(i) for i in range(N_ROWS)) + ("Sync",))

PATTERN_SEQUENCER = ModuleDef(
    type_name="Pattern Sequencer",
    make=_pat_make,
    num_inputs=_pat_nin,
    num_outputs=_pat_nout,
    input_labels=_pat_inlabels,
    output_labels=_pat_outlabels,
    init_state=_pat_init_state,
    step=_pat_step,
    block=_pat_block,
    derive=_pat_derive,
    cuda_fn="srk_pattern_sequencer",
    cuda_adj="srk_pattern_sequencer_adj",
)
