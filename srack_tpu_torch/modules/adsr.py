"""ADSR envelope generator (counterpart: ``srack_tpu/modules/adsr.py``).

The reference's per-sample state machine, branch-free: every mode's update
is computed and the current mode's is selected.  Modes are int32:
0=None 1=Attack 2=Decay 3=Sustain 4=Release.  The phase is
``p0 + float(k) * inc`` from an int32 stage counter ``k`` and an entry
offset ``p0``, the same float expression every engine evaluates.  Quirks
kept from the reference:

* linear segments with increments ``1/(sr * t_sec)``; a zero time gives
  +inf and the stage completes on the same sample;
* a retrigger during Attack resets phase and latches the current level into
  ``r_val`` so the restarted attack ramps from it;
* a rising edge during Release enters Attack with the release increment as
  the entry offset, and a same-sample release completion overrides back to
  idle with ``r_val = 0``;
* the output law runs on the post-update mode, then ``r_val`` and
  ``from_a_val`` track the emitted level.

Only the per-sample step is ported; the block implementation is slice 3.
"""

from __future__ import annotations

import torch

from ..config import AudioConfig
from ..ops.basic import transition, transition_init
from .base import CV_DTYPE, ModuleDef, const_ports, cv, in_or


def _make(cfg: AudioConfig, a_sec: float = 0.0, d_sec: float = 0.5,
          s_val: float = 0.25, r_sec: float = 0.5):
    params = {
        "a_sec": cv(a_sec),
        "d_sec": cv(d_sec),
        "s_val": cv(s_val),
        "r_sec": cv(r_sec),
    }
    return ("adsr",), params


def _init_state(cfg: AudioConfig, statics, device=None):
    return {
        "mode": torch.zeros((), dtype=torch.int32, device=device),
        "k": torch.zeros((), dtype=torch.int32, device=device),
        "p0": torch.zeros((), dtype=CV_DTYPE, device=device),
        "r_val": torch.zeros((), dtype=CV_DTYPE, device=device),
        "from_a_val": torch.zeros((), dtype=CV_DTYPE, device=device),
        "gate_last": transition_init(device),
    }


def _incs(params, sample_rate):
    sr = torch.tensor(float(sample_rate), dtype=CV_DTYPE)
    return (1.0 / (sr * params["a_sec"]),
            1.0 / (sr * params["d_sec"]),
            1.0 / (sr * params["r_sec"]))


def stage_incs(params, sample_rate):
    """Per-stage phase increments ``1/(sr * t_sec)``; the derived entries
    when present."""
    if "inc_a" in params:
        return params["inc_a"], params["inc_d"], params["inc_r"]
    return _incs(params, sample_rate)


def _derive(cfg: AudioConfig, statics, params, connected):
    inc_a, inc_d, inc_r = _incs(params, cfg.sample_rate)
    return {"inc_a": inc_a, "inc_d": inc_d, "inc_r": inc_r}


def adsr_step_core(params, state, gate, sample_rate):
    """One sample of the envelope.  Returns ``(new_state, out)``."""
    mode, k, p0 = state["mode"], state["k"], state["p0"]
    r_val, from_a_val = state["r_val"], state["from_a_val"]
    gate_last, fired = transition(state["gate_last"], gate)
    gate_hi = gate > 0.0
    inc_a, inc_d, inc_r = stage_incs(params, sample_rate)
    kf = (k + 1).to(CV_DTYPE)
    zero = torch.zeros_like(p0)
    zk = torch.zeros_like(k)

    # candidate next-phase per stage: phase = p0 + (k+1)*inc
    pa = p0 + kf * inc_a
    pd = p0 + kf * inc_d
    pr = torch.where(gate_hi, inc_r, p0 + kf * inc_r)

    # --- mode 0: idle ------------------------------------------------------
    mode_n = torch.where(gate_hi, 1, 0)
    k_n = torch.where(gate_hi, zk, k)
    p0_n = torch.where(gate_hi, zero, p0)
    ph_n = zero

    # --- mode 1: attack ----------------------------------------------------
    a_done = pa >= 1.0
    retrig_a = torch.logical_and(torch.logical_not(a_done), fired)
    a_leave = torch.logical_or(a_done, retrig_a)
    mode_a = torch.where(a_done, 2, 1)
    k_a = torch.where(a_leave, zk, k + 1)
    p0_a = torch.where(a_leave, zero, p0)
    ph_a = torch.where(a_leave, zero, pa)
    rval_a = torch.where(retrig_a, from_a_val, r_val)

    # --- mode 2: decay -----------------------------------------------------
    d_done = pd >= 1.0
    d_leave = torch.logical_or(fired, d_done)
    mode_d = torch.where(fired, 1, torch.where(d_done, 3, 2))
    k_d = torch.where(d_leave, zk, k + 1)
    p0_d = torch.where(d_leave, zero, p0)
    ph_d = torch.where(d_leave, zero, pd)

    # --- mode 3: sustain ---------------------------------------------------
    gate_lo = torch.logical_not(gate_hi)
    leave_s = torch.logical_or(gate_lo, fired)
    mode_s = torch.where(fired, 1, torch.where(gate_lo, 4, 3))
    k_s = torch.where(leave_s, zk, k)
    p0_s = torch.where(leave_s, zero, p0)
    ph_s = zero

    # --- mode 4: release ---------------------------------------------------
    r_done = pr >= 1.0
    mode_r = torch.where(r_done, 0, torch.where(gate_hi, 1, 4))
    # gate-high retrigger keeps the release increment as the attack entry
    # offset: phase' = inc_r, counted from k'=0
    k_r = torch.where(torch.logical_or(r_done, gate_hi), zk, k + 1)
    p0_r = torch.where(r_done, zero, torch.where(gate_hi, pr, p0))
    ph_r = torch.where(r_done, zero, pr)
    rval_r = torch.where(r_done, zero, r_val)

    def by_mode(v0, v1, v2, v3, v4):
        return torch.where(
            mode == 0, v0,
            torch.where(mode == 1, v1,
                        torch.where(mode == 2, v2,
                                    torch.where(mode == 3, v3, v4))))

    new_mode = by_mode(mode_n, mode_a, mode_d, mode_s, mode_r)
    new_k = by_mode(k_n, k_a, k_d, k_s, k_r)
    new_p0 = by_mode(p0_n, p0_a, p0_d, p0_s, p0_r)
    new_phase = by_mode(ph_n, ph_a, ph_d, ph_s, ph_r)
    r_mid = by_mode(r_val, rval_a, r_val, r_val, rval_r)

    out = adsr_out_law(new_mode, new_phase, r_mid, params["s_val"])

    new_r_val = torch.where(new_mode != 1, out, r_mid)
    new_from_a = torch.where(new_mode == 1, out, from_a_val)

    new_state = {
        "mode": new_mode.to(torch.int32),
        "k": new_k.to(torch.int32),
        "p0": new_p0.to(CV_DTYPE),
        "r_val": new_r_val.to(CV_DTYPE),
        "from_a_val": new_from_a.to(CV_DTYPE),
        "gate_last": gate_last,
    }
    return new_state, out


def adsr_out_law(mode, phase, r_mid, s_val):
    """Post-update output law per stage."""
    return torch.where(
        mode == 0, 0.0,
        torch.where(mode == 1, r_mid + (1.0 - r_mid) * phase,
                    torch.where(mode == 2,
                                s_val + (1.0 - s_val) * (1.0 - phase),
                                torch.where(mode == 3, s_val,
                                            s_val * (1.0 - phase))))
    ).to(CV_DTYPE)


def _step(cfg: AudioConfig, statics, params, state, ins, x=None):
    gate = in_or(ins[0], 0.0, state["mode"])
    new_state, out = adsr_step_core(params, state, gate, cfg.sample_rate)
    return new_state, (out,)


_nin, _inlabels = const_ports(1, ("Gate",))
_nout, _outlabels = const_ports(1, (None,))

ADSR = ModuleDef(
    type_name="ADSR",
    make=_make,
    num_inputs=_nin,
    num_outputs=_nout,
    input_labels=_inlabels,
    output_labels=_outlabels,
    init_state=_init_state,
    step=_step,
    derive=_derive,
    cuda_fn="srk_adsr",
    cuda_adj="srk_adsr_adj",
)
