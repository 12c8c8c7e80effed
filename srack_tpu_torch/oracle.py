"""NumPy oracle: a literal, slow reimplementation of the reference engine
(counterpart: ``srack_tpu/oracle.py``, of which this is a copy: the JAX
package's imports ``..patch``, which imports jax, so it cannot be shared).

This module re-states the Rust reference's per-sample semantics
(src/synth.rs execute + every module's calc loop) directly in
Python/NumPy -- mutable module objects, per-output buffers, block-at-a-time
execution in plan order, previous-buffer feedback.  It shares *nothing* with
the torch engines except the Patch IR, so agreement between the two is a
real cross-implementation test (SURVEY.md §4 implication c).  Only the
imports differ from the JAX package's copy: the port's Patch and planner,
the port's Freeverb constants, and the params read as numpy (``np.asarray``
of a CPU tensor).

It is intended for tests and debugging only; the engines are the product.
Noise is not supported (the reference uses non-reproducible ``rand::random``,
oscillator.rs:385) -- drive stochastic tests through Input modules instead.
"""

from __future__ import annotations

import math

import numpy as np

from .patch import Patch
from .planner import plan_execution

F32 = np.float32


def _f32(x):
    return F32(x)


class _Detector:
    """TransitionDetector (synth.rs:277-298); last initialised True."""

    def __init__(self):
        self.last = True

    def fire(self, val: float) -> bool:
        above = val > 0.0
        fired = above and not self.last
        self.last = above
        return fired


class _Module:
    def __init__(self, inst, cfg):
        self.inst = inst
        self.cfg = cfg
        self.n_out = inst.mdef.num_outputs(cfg, inst.statics)
        self.bufs = [np.zeros(cfg.block_size, dtype=F32)
                     for _ in range(self.n_out)]

    def resolve(self, modules, idx):
        conn = self.inst.inputs[idx]
        if conn is None:
            return None
        src, sport = conn
        buf = modules[src].bufs[sport]
        # Self-edge (a 1-cycle): snapshot the previous block's content so
        # in-place writes during this calc can't alias the read.  The
        # reference cannot express this case at all -- a self-wired module
        # deadlocks its buffer RwLock (read + write of the same lock,
        # mixer.rs:102-120) -- so the framework defines the semantics as
        # ordinary feedback: the broken edge reads the previous block,
        # exactly like any other cycle (synth.rs:168-192).
        if any(buf is b for b in self.bufs):
            return buf.copy()
        return buf

    def p(self, name):
        v = self.inst.params[name]
        return np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)

    def calc(self, modules):
        raise NotImplementedError


class _Oscillator(_Module):
    def __init__(self, inst, cfg):
        super().__init__(inst, cfg)
        self.pos = 0.0  # f64
        self.sync = _Detector()

    @staticmethod
    def poly_blep(t: float, dt: float) -> float:
        if dt == 0.0:
            return 0.0
        if t < dt:
            t /= dt
            return t + t - t * t - 1.0
        elif t > 1.0 - dt:
            t = (t - 1.0) / dt
            return t * t + t + t + 1.0
        return 0.0

    def calc(self, modules):
        cv = self.resolve(modules, 0)
        sync = self.resolve(modules, 1)
        val = float(self.p("val"))
        sine, square, saw = self.bufs
        for i in range(self.cfg.block_size):
            sv = float(sync[i]) if sync is not None else 0.0
            if self.sync.fire(sv):
                self.pos = 0.0
            octs = val if cv is None else float(cv[i]) + val
            delta = 440.0 * (2.0 ** octs) / self.cfg.sample_rate
            sine[i] = _f32(math.sin(self.pos * math.pi * 2.0))
            sq = -1.0 if self.pos < 0.5 else 1.0
            square[i] = _f32(sq) - _f32(
                self.poly_blep(self.pos, delta)
                - self.poly_blep((self.pos + 0.5) % 1.0, delta))
            saw[i] = _f32(_f32(self.pos) * _f32(2.0) - _f32(1.0)) - _f32(
                self.poly_blep(self.pos, delta))
            self.pos += delta
            self.pos %= 1.0


class _Input(_Module):
    def __init__(self, inst, cfg):
        super().__init__(inst, cfg)
        self.driver = None
        self.offset = 0

    def calc(self, modules):
        b = self.bufs[0]
        if self.driver is None:
            b[:] = _f32(float(self.p("value")))
        else:
            b[:] = self.driver[self.offset:self.offset + self.cfg.block_size]
            self.offset += self.cfg.block_size


class _Noise(_Input):
    """Reference noise is non-reproducible ``rand::random``
    (oscillator.rs:385); for cross-validation the oracle consumes the JAX
    engine's own threefry lanes injected via ``oracle_render(noise=...)``
    (fall back to the constant-0 Input behaviour otherwise)."""

    def calc(self, modules):
        b = self.bufs[0]
        if self.driver is None:
            b[:] = 0.0
        else:
            b[:] = self.driver[self.offset:self.offset + self.cfg.block_size]
            self.offset += self.cfg.block_size


class _Moog(_Module):
    def __init__(self, inst, cfg):
        super().__init__(inst, cfg)
        self.b = np.zeros(5, dtype=F32)

    def calc(self, modules):
        audio_in = self.resolve(modules, 0)
        cv_in = self.resolve(modules, 1)
        freq0, res0, exp_amt = (
            _f32(self.p("freq")), _f32(self.p("res")), _f32(self.p("exp_amt")))
        lp_buf, bp_buf, hp_buf = self.bufs
        b = self.b
        for i in range(self.cfg.block_size):
            audio = audio_in[i] if audio_in is not None else _f32(0.0)
            cvv = cv_in[i] if cv_in is not None else _f32(0.0)
            frequency = min(max(_f32(freq0 + cvv * exp_amt), _f32(0.0)), _f32(0.9))
            res = min(max(res0, _f32(0.0)), _f32(1.0))
            q0 = _f32(1.0) - frequency
            pc = _f32(frequency + _f32(0.8) * frequency * q0)
            f = _f32(pc * 2.0 - 1.0)
            q = _f32(res * (_f32(1.0) + _f32(0.5) * q0 *
                            (_f32(1.0) - q0 + _f32(5.6) * q0 * q0)))
            x = _f32(audio - q * b[4])
            t1 = b[1]
            b[1] = _f32((x + b[0]) * pc - b[1] * f)
            t2 = b[2]
            b[2] = _f32((b[1] + t1) * pc - b[2] * f)
            t1 = b[3]
            b[3] = _f32((b[2] + t2) * pc - b[3] * f)
            b[4] = _f32((b[3] + t1) * pc - b[4] * f)
            b[4] = _f32(b[4] - b[4] ** 3 * _f32(0.166667))
            b[0] = x
            np.clip(b, -1.0, 1.0, out=b)
            lp_buf[i] = b[4]
            hp_buf[i] = _f32(x - b[4])
            bp_buf[i] = _f32(3.0 * (b[3] - b[4]))


class _ADSR(_Module):
    NONE, ATTACK, DECAY, SUSTAIN, RELEASE = range(5)

    def __init__(self, inst, cfg):
        super().__init__(inst, cfg)
        self.phase = _f32(0.0)
        self.mode = self.NONE
        self.r_val = _f32(0.0)
        self.from_a_val = _f32(0.0)
        self.det = _Detector()

    def calc(self, modules):
        gate_buf = self.resolve(modules, 0)
        a_sec, d_sec = _f32(self.p("a_sec")), _f32(self.p("d_sec"))
        s_val, r_sec = _f32(self.p("s_val")), _f32(self.p("r_sec"))
        sr = _f32(self.cfg.sample_rate)
        out = self.bufs[0]
        for i in range(self.cfg.block_size):
            gate = gate_buf[i] if gate_buf is not None else _f32(0.0)
            fired = self.det.fire(float(gate))
            gate_hi = gate_buf is not None and gate > 0.0
            m = self.mode
            if m == self.NONE:
                if gate_hi:
                    self.phase = _f32(0.0)
                    self.mode = self.ATTACK
            elif m == self.ATTACK:
                with np.errstate(divide="ignore"):
                    self.phase = _f32(self.phase + _f32(1.0) / (sr * a_sec))
                if self.phase >= 1.0:
                    self.phase = _f32(0.0)
                    self.mode = self.DECAY
                elif fired:
                    self.phase = _f32(0.0)
                    self.r_val = self.from_a_val
            elif m == self.DECAY:
                with np.errstate(divide="ignore"):
                    self.phase = _f32(self.phase + _f32(1.0) / (sr * d_sec))
                if self.phase >= 1.0:
                    self.phase = _f32(0.0)
                    self.mode = self.SUSTAIN
                if fired:
                    self.phase = _f32(0.0)
                    self.mode = self.ATTACK
            elif m == self.SUSTAIN:
                if gate_buf is None or gate <= 0.0:
                    self.phase = _f32(0.0)
                    self.mode = self.RELEASE
                if fired:
                    self.phase = _f32(0.0)
                    self.mode = self.ATTACK
            elif m == self.RELEASE:
                if gate_hi:
                    self.phase = _f32(0.0)
                    self.mode = self.ATTACK
                with np.errstate(divide="ignore"):
                    self.phase = _f32(self.phase + _f32(1.0) / (sr * r_sec))
                if self.phase >= 1.0:
                    self.phase = _f32(0.0)
                    self.r_val = _f32(0.0)
                    self.mode = self.NONE
            m = self.mode
            if m == self.NONE:
                out[i] = 0.0
            elif m == self.ATTACK:
                out[i] = _f32(self.r_val + (_f32(1.0) - self.r_val) * self.phase)
            elif m == self.DECAY:
                out[i] = _f32(s_val + (_f32(1.0) - s_val) * (_f32(1.0) - self.phase))
            elif m == self.SUSTAIN:
                out[i] = s_val
            else:
                out[i] = _f32(s_val * (_f32(1.0) - self.phase))
            if m != self.ATTACK:
                self.r_val = out[i]
            else:
                self.from_a_val = out[i]


class _VCA(_Module):
    def calc(self, modules):
        audio = self.resolve(modules, 0)
        cvb = self.resolve(modules, 1)
        negative = self.inst.statics[1]
        out = self.bufs[0]
        if audio is None or cvb is None:
            out[:] = 0.0
            return
        for i in range(self.cfg.block_size):
            if negative or cvb[i] > 0.0:
                out[i] = _f32(audio[i] * cvb[i])
            else:
                out[i] = 0.0


class _Mixer(_Module):
    def calc(self, modules):
        out = self.bufs[0]
        gains = self.p("gain")
        # resolve every input BEFORE writing: a self-edge resolves to a
        # snapshot of the previous block (see resolve), and must not see
        # this block's partial sums
        bufs = [self.resolve(modules, idx)
                for idx in range(len(self.inst.inputs))]
        out[:] = 0.0
        for idx, buf in enumerate(bufs):
            if buf is None:
                continue
            for i in range(self.cfg.block_size):
                out[i] = _f32(out[i] + buf[i] * _f32(gains[idx]))


class _Math(_Module):
    def calc(self, modules):
        op = self.inst.statics[1]
        i1 = self.resolve(modules, 0)
        i2 = self.resolve(modules, 1)
        const = _f32(self.p("constant"))
        out = self.bufs[0]
        for i in range(self.cfg.block_size):
            a = i1[i] if i1 is not None else _f32(0.0)
            b = i2[i] if i2 is not None else const
            if op == "Add":
                out[i] = _f32(a + b)
            elif op == "Subtract":
                out[i] = _f32(a - b)
            else:
                out[i] = _f32(a * b)


class _NonLinear(_Module):
    def calc(self, modules):
        i1 = self.resolve(modules, 0)
        i2 = self.resolve(modules, 1)
        const = _f32(self.p("constant"))
        out = self.bufs[0]
        # 0^negative legitimately overflows to inf (the reference's
        # 0.0f32.powf(-b) does too, math.rs:202-206); silence the numpy
        # warning — the inf itself is the correct, engine-matching output
        # (tests/test_fuzz.py::test_fuzz_nonlinear_inf_parity)
        with np.errstate(divide="ignore"):
            for i in range(self.cfg.block_size):
                a = i1[i] if i1 is not None else _f32(0.0)
                b = i2[i] if i2 is not None else const
                if a > 0.0:
                    out[i] = _f32(a) ** _f32(b)
                else:
                    out[i] = -((-_f32(a)) ** _f32(b))


class _GridSeq(_Module):
    def __init__(self, inst, cfg):
        super().__init__(inst, cfg)
        self.current_step = 0
        self.det = _Detector()
        self.sync_det = _Detector()
        self.last = _f32(0.0)

    def calc(self, modules):
        step_buf = self.resolve(modules, 0)
        sync_buf = self.resolve(modules, 1)
        notes = self.p("notes")
        cells = self.p("cells")
        n_steps = int(self.p("n_steps"))
        spo = _f32(self.p("steps_per_octave"))
        cv_out, gate_out, sync_out = self.bufs
        for i in range(self.cfg.block_size):
            step_in = step_buf[i] if step_buf is not None else _f32(0.0)
            sync_in = sync_buf[i] if sync_buf is not None else _f32(0.0)
            if self.det.fire(float(step_in)):
                self.current_step += 1
            if self.sync_det.fire(float(sync_in)):
                self.current_step = 0
            if self.current_step >= n_steps:
                self.current_step = 0
            cs = self.current_step
            if cells[cs] > 0:
                cv_out[i] = _f32(notes[cs] * (_f32(1.0) / spo))
                gate_out[i] = _f32(1.0) if cells[cs] == 2 else step_in
            else:
                cv_out[i] = self.last
                gate_out[i] = 0.0
            sync_out[i] = 1.0 if cs == 0 else 0.0
            self.last = cv_out[i]


class _PatternSeq(_Module):
    def __init__(self, inst, cfg):
        super().__init__(inst, cfg)
        self.current_step = 0
        self.det = _Detector()
        self.sync_det = _Detector()

    def calc(self, modules):
        step_buf = self.resolve(modules, 0)
        sync_buf = self.resolve(modules, 1)
        cells = self.p("cells")
        n_steps = int(self.p("n_steps"))
        n_rows = cells.shape[0]
        for i in range(self.cfg.block_size):
            step_in = step_buf[i] if step_buf is not None else _f32(0.0)
            sync_in = sync_buf[i] if sync_buf is not None else _f32(0.0)
            if self.det.fire(float(step_in)):
                self.current_step += 1
            if self.sync_det.fire(float(sync_in)):
                self.current_step = 0
            if self.current_step >= n_steps:
                self.current_step = 0
            cs = self.current_step
            for r in range(n_rows):
                c = cells[r, cs]
                self.bufs[r][i] = (
                    _f32(1.0) if c == 2 else (step_in if c == 1 else _f32(0.0)))
            self.bufs[n_rows][i] = 1.0 if cs == 0 else 0.0


class _Sample(_Module):
    def __init__(self, inst, cfg):
        super().__init__(inst, cfg)
        self.pos = _f32(0.0)
        self.playing = False
        self.det = _Detector()

    def calc(self, modules):
        gate_buf = self.resolve(modules, 0)
        cv_buf = self.resolve(modules, 1)
        samples = self.p("samples")
        length = int(self.p("length"))
        wav_sr = _f32(self.p("wav_sr"))
        out = self.bufs[0]
        for i in range(self.cfg.block_size):
            gate = gate_buf[i] if gate_buf is not None else _f32(0.0)
            if self.det.fire(float(gate)):
                self.pos = _f32(0.0)
                self.playing = True
            if int(self.pos) >= length:
                self.pos = _f32(0.0)
                self.playing = False
            if length > 0:
                out[i] = samples[int(self.pos)]
            else:
                out[i] = 0.0
            if self.playing:
                cvv = cv_buf[i] if cv_buf is not None else _f32(0.0)
                self.pos = _f32(
                    self.pos + wav_sr / _f32(self.cfg.sample_rate)
                    * _f32(2.0) ** cvv)


class _Freeverb(_Module):
    """f64 Jezar freeverb, the crate the reference wraps (freeverb.rs:88-114)."""

    def __init__(self, inst, cfg):
        super().__init__(inst, cfg)
        from .modules.freeverb import (
            line_lengths, ALLPASS_FEEDBACK, FIXED_GAIN, OFFSET_ROOM,
            SCALE_DAMPENING, SCALE_ROOM, SCALE_WET)
        cl, cr, al, ar = line_lengths(cfg.sample_rate)
        self.combs = [[np.zeros(n) for n in cl], [np.zeros(n) for n in cr]]
        self.comb_fs = [np.zeros(len(cl)), np.zeros(len(cr))]
        self.comb_idx = [np.zeros(len(cl), dtype=int),
                         np.zeros(len(cr), dtype=int)]
        self.aps = [[np.zeros(n) for n in al], [np.zeros(n) for n in ar]]
        self.ap_idx = [np.zeros(len(al), dtype=int),
                       np.zeros(len(ar), dtype=int)]
        frozen = bool(self.p("freeze"))
        self.damp = 0.0 if frozen else float(self.p("dampening")) * SCALE_DAMPENING
        self.feed = 1.0 if frozen else float(self.p("room_size")) * SCALE_ROOM + OFFSET_ROOM
        self.in_gain = 0.0 if frozen else FIXED_GAIN
        wet = float(self.p("wet")) * SCALE_WET
        width = float(self.p("width"))
        self.wet1 = wet * (width / 2.0 + 0.5)
        self.wet2 = wet * ((1.0 - width) / 2.0)
        self.dry = float(self.p("dry"))
        self.ap_feedback = ALLPASS_FEEDBACK

    def _comb(self, ch, j, x):
        buf, idx = self.combs[ch][j], self.comb_idx[ch][j]
        out = buf[idx]
        self.comb_fs[ch][j] = out * (1.0 - self.damp) + self.comb_fs[ch][j] * self.damp
        buf[idx] = x + self.comb_fs[ch][j] * self.feed
        self.comb_idx[ch][j] = (idx + 1) % len(buf)
        return out

    def _allpass(self, ch, j, x):
        buf, idx = self.aps[ch][j], self.ap_idx[ch][j]
        delayed = buf[idx]
        out = delayed - x
        buf[idx] = x + delayed * self.ap_feedback
        self.ap_idx[ch][j] = (idx + 1) % len(buf)
        return out

    def calc(self, modules):
        l_buf = self.resolve(modules, 0)
        r_buf = self.resolve(modules, 1)
        lo, ro = self.bufs
        for i in range(self.cfg.block_size):
            l = float(l_buf[i]) if l_buf is not None else 0.0
            r = float(r_buf[i]) if r_buf is not None else 0.0
            mixed = (l + r) * self.in_gain
            out_l = out_r = 0.0
            for j in range(len(self.combs[0])):
                out_l += self._comb(0, j, mixed)
                out_r += self._comb(1, j, mixed)
            for j in range(len(self.aps[0])):
                out_l = self._allpass(0, j, out_l)
                out_r = self._allpass(1, j, out_r)
            lo[i] = _f32(out_l * self.wet1 + out_r * self.wet2 + l * self.dry)
            ro[i] = _f32(out_r * self.wet1 + out_l * self.wet2 + r * self.dry)


class _Output(_Module):
    def __init__(self, inst, cfg):
        super().__init__(inst, cfg)
        self.bufs = [np.zeros(cfg.block_size, dtype=F32)
                     for _ in range(cfg.channels)]

    def calc(self, modules):
        for c in range(self.cfg.channels):
            buf = self.resolve(modules, c)
            self.bufs[c][:] = 0.0 if buf is None else buf


_ORACLE_TYPES = {
    "Oscillator": _Oscillator,
    "Input": _Input,
    "Noise": _Noise,
    "Moog Filter": _Moog,
    "ADSR": _ADSR,
    "VCA": _VCA,
    "Mono Mixer": _Mixer,
    "Add": _Math,
    "Subtract": _Math,
    "Multiply": _Math,
    "Non-Linear": _NonLinear,
    "Grid Sequencer": _GridSeq,
    "Pattern Sequencer": _PatternSeq,
    "Sample": _Sample,
    "Freeverb": _Freeverb,
    "Output": _Output,
}


def oracle_render(patch: Patch, n_samples: int, drivers: dict | None = None,
                  noise: dict | None = None):
    """Render with literal reference semantics.  Returns [channels, n] f32.

    ``n_samples`` is rounded up to whole blocks internally and trimmed,
    exactly as the reference always computes whole buffers.  ``noise`` maps
    Noise module ids to pre-generated [n_blocks*block] sample arrays (use
    ``compiled._make_xs`` to inject the engine's own lanes).
    """
    cfg = patch.config
    plan, _ = plan_execution(patch)
    modules = {}
    for inst in patch:
        cls = _ORACLE_TYPES.get(inst.mdef.type_name)
        if cls is None:
            raise NotImplementedError(
                f"oracle does not support {inst.mdef.type_name}")
        modules[inst.id] = cls(inst, cfg)
    n_blocks = -(-n_samples // cfg.block_size)
    total = n_blocks * cfg.block_size

    def _bind(mapping):
        for module, arr in (mapping or {}).items():
            mid = module if isinstance(module, str) else module.id
            a = np.asarray(arr, dtype=F32)
            if a.shape[0] < total:
                a = np.pad(a, (0, total - a.shape[0]))
            modules[mid].driver = a

    _bind(drivers)
    _bind(noise)
    out_mod = modules[patch.output.id]
    chans = [np.zeros(n_blocks * cfg.block_size, dtype=F32)
             for _ in range(cfg.channels)]
    for b in range(n_blocks):
        for mid in plan:
            modules[mid].calc(modules)
        sl = slice(b * cfg.block_size, (b + 1) * cfg.block_size)
        for c in range(cfg.channels):
            chans[c][sl] = out_mod.bufs[c]
    return np.stack(chans)[:, :n_samples]
