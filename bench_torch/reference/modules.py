"""Plain references of the module types the configurations use, each over
a whole signal of ``n`` samples of ``v`` voices at once.

The semantics are s-rack's modules (``src/synth``) in srack_tpu's fast
precision, written from their equations: the phase an int32 fixed-point
accumulator that wraps mod 2^32, sin(pi s) and 2^x by their fixed
polynomials, polyBLEP in the signed-phase domain, the ADSR's per-sample
state machine with the reference's quirks, the musicdsp Moog ladder, the
Freeverb crate's combs and allpasses.  Nothing here imports the program.

Each function takes ``(prec, params, ins, v, n, sr)``: the precision
(``precision.F32``, or ``BF16`` for the control), the module's params as
``[v]`` numpy arrays, its connected inputs ``{label: signal}`` (torch CPU
tensors of ``prec.dtype``, ``[v, n]`` or broadcastable to it), the voices,
the length and the sample rate.  It returns ``{port: signal}``, each
output under its index and its label.
"""

from __future__ import annotations

import numpy as np
import torch

_SINPI = (3.1415278983587682, -5.166401774862824, 2.5427129265355948,
          -0.5818593382178273, 0.0640261396169806)
_EXP2 = (1.0000000018561317, 0.6931469838082407, 0.24022983671380171,
         0.05548333989618637, 0.009678845362499107, 0.0012439646470418081,
         0.00021702400581973962)
TWO32 = 4294967296.0


def _col(prec, a) -> torch.Tensor:
    """A per-voice param as a ``[v, 1]`` signal of ``prec.dtype``."""
    a = np.asarray(a, dtype=np.float32).reshape(-1, 1)
    return torch.from_numpy(np.ascontiguousarray(a)).to(prec.dtype)


def _zeros(prec, v, n):
    return torch.zeros((v, n), dtype=prec.dtype)


def _time_major(prec, x, v, n) -> np.ndarray:
    """A signal as a contiguous ``[n, v]`` float32 array."""
    return np.ascontiguousarray(prec.numpy(torch.broadcast_to(x, (v, n))).T)


def exp2(prec, x):
    x = torch.clamp(x, -126.0, 126.0)
    xi = torch.floor(x)
    f = x - xi
    p = torch.full_like(x, _EXP2[6])
    for k in (5, 4, 3, 2, 1, 0):
        p = p * f + _EXP2[k]
    scale = ((xi.to(torch.int32) + 127) << 23).view(torch.float32)
    return p * scale.to(prec.dtype)


def sinpi(s):
    z = s * s
    p = torch.full_like(s, _SINPI[4])
    for k in (3, 2, 1, 0):
        p = p * z + _SINPI[k]
    return s * p


def to_fixed(delta):
    """Cycles per sample -> the int32 phase increment (wrapped to [0, 1)
    first, values of half a cycle or more as their negative pattern)."""
    r = torch.fmod(delta, 1.0)
    d = torch.where(r < 0.0, r + 1.0, r)
    u = d * TWO32
    lo = d < 0.5
    small = torch.where(lo, u, 0.0).to(torch.int32)
    big = torch.where(lo, 0.0, u - TWO32).to(torch.int32)
    return torch.where(lo, small, big)


def _wrap(x64):
    return ((x64 + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def blep(u):
    au = torch.where(u >= 0.0, u, -u)
    w = 1.0 - au
    mag = torch.where(au < 1.0, w * w, 0.0)
    return torch.where(u >= 0.0, -mag, mag)


def oscillator(prec, params, ins, v, n, sr, antialiasing=True):
    if "Sync" in ins:
        raise NotImplementedError("the reference has no Sync input")
    val = _col(prec, params["val"])
    octs = val if "CV" not in ins else ins["CV"] + val
    delta = exp2(prec, octs) * (440.0 / sr)
    dfix = to_fixed(delta).to(torch.int64)
    if dfix.shape[-1] == 1:
        pos = _wrap(dfix * torch.arange(n, dtype=torch.int64))
        delta = delta.expand(v, n)
    else:
        pos = _wrap(torch.cumsum(dfix, -1) - dfix)
    s = pos.to(prec.dtype) * (1.0 / 2147483648.0)
    sine = sinpi(s)
    square = torch.where(pos >= 0, -1.0, 1.0).to(prec.dtype)
    saw = s + square
    if antialiasing:
        inv2dt = 0.5 / delta
        b0 = blep(s * inv2dt)
        bh = blep(saw * inv2dt)
        square = square - (b0 - bh)
        saw = saw - b0
    return {0: sine, "Sine": sine, 1: square, "Square": square,
            2: saw, "Sawtooth": saw}


def multiply(prec, params, ins, v, n, sr):
    a = ins.get("In1", _zeros(prec, v, n))
    b = ins.get("In2", _col(prec, params["constant"]))
    return {0: torch.broadcast_to(a * b, (v, n))}


def vca(prec, params, ins, v, n, sr, negative=False):
    if "Audio" not in ins or "CV" not in ins:
        return {0: _zeros(prec, v, n)}
    a, c = ins["Audio"], ins["CV"]
    out = a * c if negative else torch.where(c > 0.0, a * c, 0.0)
    return {0: torch.broadcast_to(out.to(prec.dtype), (v, n))}


def moog_filter(prec, params, ins, v, n, sr):
    """The ladder one sample at a time, every voice at once, each op rounded
    by ``prec.r``.  A step's signals sit as rows of one ``[10, v]`` buffer,
    ``(n3, n4, n1, n2, x, b3, b4, b1, b2, b0)``, so that the clamp of all
    five is one op, and ``x, b3, b4`` (what the outputs need) are
    adjacent; two buffers take turns as this step's and the last."""
    if "CV" in ins:
        raise NotImplementedError("the reference has no cutoff CV input")
    R, C = prec.r, prec.const
    one, zero = C(1.0), C(0.0)
    freq = np.minimum(np.maximum(prec.array(params["freq"]), zero), C(0.9))
    res = np.minimum(np.maximum(prec.array(params["res"]), zero), one)
    q0 = R(one - freq)
    p = R(freq + R(R(C(0.8) * freq) * q0))
    f = R(R(p * C(2.0)) - one)
    q = R(res * R(one + R(R(C(0.5) * q0)
                          * R(R(one - q0) + R(R(C(5.6) * q0) * q0)))))
    audio = (_time_major(prec, ins["Audio"], v, n) if "Audio" in ins
             else np.zeros((n, v), np.float32))
    lo, c = C(-1.0), C(0.166667)
    kept = np.empty((n, 3, v), np.float32)
    u = np.empty(v, np.float32)
    bf = np.empty((4, v), np.float32)
    bf3, bf4, bf1, bf2 = bf
    add, mul, sub = np.add, np.multiply, np.subtract
    bufs = []
    for _ in range(2):
        z = np.zeros((10, v), np.float32)
        bufs.append((z, z[:5], z[5:], z[4:7], z[5:9], *z))
    last, this = bufs
    for t in range(n):
        (_, ns, _, _, _, n3, n4, n1, n2, x, _, _, _, _, _) = this
        (_, _, bs, _, b_f, _, _, _, _, _, b3, b4, b1, b2, b0) = last
        R(mul(q, b4, out=u))
        R(sub(audio[t], u, out=x))
        R(mul(b_f, f, out=bf))
        R(add(x, b0, out=u))
        R(mul(u, p, out=u))
        R(sub(u, bf1, out=n1))
        R(add(n1, b1, out=u))
        R(mul(u, p, out=u))
        R(sub(u, bf2, out=n2))
        R(add(n2, b2, out=u))
        R(mul(u, p, out=u))
        R(sub(u, bf3, out=n3))
        R(add(n3, b3, out=u))
        R(mul(u, p, out=u))
        R(sub(u, bf4, out=n4))
        R(mul(n4, n4, out=u))
        R(mul(u, n4, out=u))
        R(mul(u, c, out=u))
        R(sub(n4, u, out=n4))
        out = this[2]
        np.minimum(np.maximum(ns, lo, out=out), one, out=out)
        kept[t] = this[3]
        last, this = this, last
    xs, b3s, b4s = kept[:, 0], kept[:, 1], kept[:, 2]
    hp = R(xs - b4s)
    bp = R(C(3.0) * R(b3s - b4s))
    lp, bp, hp = (prec.signal(a.T) for a in (b4s, bp, hp))
    return {0: lp, 1: bp, 2: hp}


_NONE = np.zeros(0, np.float32)


class _Envelope:
    """One voice's ADSR.  Modes: 0 idle, 1 attack, 2 decay, 3 sustain, 4
    release; a stage's phase is ``p0 + (k + 1) * inc`` with ``inc = 1 /
    (sr * t)``.  ``step`` is the state machine for one sample; ``run``
    covers, in one go, a stretch where the gate holds and the stage goes
    on (the phase of each sample computed as ``step`` would)."""

    def __init__(self, prec, inc_a, inc_d, inc_r, s_val):
        self.R, self.one, self.zero = prec.r, prec.const(1.0), prec.const(0.0)
        self.inc = {1: inc_a, 2: inc_d, 4: inc_r}
        self.s = s_val
        self.mode, self.k, self.p0 = 0, 0, self.zero
        self.r_val = self.from_a = self.zero
        self.last = True

    def level(self, mode, r_mid, ph):
        R, one = self.R, self.one
        if mode == 0:
            return self.zero + 0 * ph
        if mode == 1:
            return R(r_mid + R(R(one - r_mid) * ph))
        if mode == 2:
            return R(self.s + R(R(one - self.s) * R(one - ph)))
        if mode == 3:
            return self.s + 0 * ph
        return R(self.s * R(one - ph))

    def step(self, hi: bool):
        R, one, zero = self.R, self.one, self.zero
        fired = hi and not self.last
        self.last = hi
        kf = R(np.float32(self.k + 1))
        r_mid = self.r_val
        mode, k, p0 = self.mode, self.k, self.p0
        if mode == 0:
            mode, k, p0, ph = (1, 0, zero, zero) if hi else (0, k, p0, zero)
        elif mode == 1:
            pa = R(p0 + R(kf * self.inc[1]))
            done = pa >= one
            retrig = (not done) and fired
            if retrig:
                r_mid = self.from_a
            if done or retrig:
                mode, k, p0, ph = (2 if done else 1), 0, zero, zero
            else:
                k, ph = k + 1, pa
        elif mode == 2:
            pd = R(p0 + R(kf * self.inc[2]))
            done = pd >= one
            if fired or done:
                mode, k, p0, ph = (1 if fired else 3), 0, zero, zero
            else:
                k, ph = k + 1, pd
        elif mode == 3:
            ph = zero
            if fired or not hi:
                mode, k, p0 = (1 if fired else 4), 0, zero
        else:
            pr = self.inc[4] if hi else R(p0 + R(kf * self.inc[4]))
            if pr >= one:
                mode, k, p0, ph, r_mid = 0, 0, zero, zero, zero
            elif hi:
                mode, k, p0, ph = 1, 0, pr, pr
            else:
                k, ph = k + 1, pr
        o = self.level(mode, r_mid, ph)
        self.mode, self.k, self.p0 = mode, k, p0
        self.r_val = o if mode != 1 else r_mid
        if mode == 1:
            self.from_a = o
        return o

    def run(self, hi: bool, m: int):
        """The levels of up to ``m`` samples over which the gate stays
        ``hi`` (and was ``hi`` the sample before): as many as pass before
        the stage would change, possibly none."""
        R, mode = self.R, self.mode
        if (mode == 0 and not hi) or (mode == 3 and hi):
            o = self.level(mode, self.r_val, np.zeros(m, np.float32))
            self.r_val = o[-1]
            return o
        if mode not in (1, 2) and not (mode == 4 and not hi):
            return _NONE
        kf = R(np.arange(self.k + 1, self.k + 1 + m).astype(np.float32))
        ph = R(self.p0 + R(kf * self.inc[mode]))
        over = np.flatnonzero(ph >= self.one)
        ph = ph[:over[0]] if over.size else ph
        if not ph.size:
            return _NONE
        o = self.level(mode, self.r_val, ph)
        self.k += ph.size
        if mode == 1:
            self.from_a = o[-1]
        else:
            self.r_val = o[-1]
        return o


def adsr(prec, params, ins, v, n, sr):
    """Each voice's envelope over its gate: one ``step`` at every edge of
    the gate and wherever a stage ends, ``run`` between them."""
    R, C = prec.r, prec.const
    one = C(1.0)
    srf = C(float(sr))
    inc_a = R(one / R(srf * prec.array(params["a_sec"])))
    inc_d = R(one / R(srf * prec.array(params["d_sec"])))
    inc_r = R(one / R(srf * prec.array(params["r_sec"])))
    s_val = prec.array(params["s_val"])
    gate = (torch.broadcast_to(ins["Gate"], (v, n)) > 0.0).numpy() \
        if "Gate" in ins else np.zeros((v, n), bool)
    out = np.empty((v, n), np.float32)
    for i in range(v):
        env = _Envelope(prec, inc_a[i], inc_d[i], inc_r[i], s_val[i])
        g = gate[i]
        edges = np.append(np.flatnonzero(g[1:] != g[:-1]) + 1, n)
        t, e = 0, 0
        while t < n:
            if t and g[t] == g[t - 1]:
                while edges[e] <= t:
                    e += 1
                o = env.run(bool(g[t]), int(edges[e]) - t)
                if o.size:
                    out[i, t:t + o.size] = o
                    t += o.size
                    continue
            out[i, t] = env.step(bool(g[t]))
            t += 1
    return {0: prec.signal(out)}


# Freeverb (the freeverb crate, Jezar's tunings at 44.1 kHz)
COMBS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
ALLPASSES = (556, 441, 341, 225)
SPREAD = 23


def _scaled(t, sr):
    return max(1, (t * sr) // 44100)


def _one_pole(prec, x, a, b, y0):
    """``y[t] = b * x[t] + a * y[t - 1]`` from ``y[-1] = y0`` over a block
    ``[v, m]``, per voice ``a``, ``b`` and ``y0`` (``[v]`` float32): the
    comb's damping filter, computed in float32 (bit for bit the program's
    f32 combs) and kept in the precision's type."""
    from scipy.signal import lfilter
    xs = prec.numpy(x)
    zi = (a * y0).astype(np.float32).reshape(-1, 1)
    if np.all(a == a[0]) and np.all(b == b[0]):
        y, _ = lfilter(np.array([b[0]], np.float32),
                       np.array([1.0, -a[0]], np.float32), xs, axis=-1,
                       zi=zi)
    else:
        y = np.stack([lfilter(np.array([b[i]], np.float32),
                              np.array([1.0, -a[i]], np.float32), xs[i],
                              zi=zi[i])[0] for i in range(xs.shape[0])])
    return prec.signal(y.astype(np.float32))


def _comb(prec, x, length, damp, feed):
    """One comb over the whole signal ``[v, n]``, ``length`` samples a
    block: a block reads what the previous block wrote."""
    v, n = x.shape
    out = torch.zeros((v, n), dtype=prec.dtype)
    line = torch.zeros((v, length), dtype=prec.dtype)
    fs = np.zeros(v, np.float32)
    a = prec.numpy(damp).reshape(-1)
    b = prec.numpy(torch.tensor(1.0, dtype=prec.dtype) - damp).reshape(-1)
    a, b = np.broadcast_to(a, (v,)), np.broadcast_to(b, (v,))
    for s in range(0, n, length):
        e = min(n, s + length)
        m = e - s
        read = line[:, :m]
        out[:, s:e] = read
        fsb = _one_pole(prec, read, a, b, fs)
        fs = prec.numpy(fsb[:, -1])
        wrote = x[:, s:e] + fsb * feed
        line = torch.cat([line[:, m:], wrote], 1) if m < length else wrote
    return out


def _allpass(prec, x, length):
    v, n = x.shape
    out = torch.zeros((v, n), dtype=prec.dtype)
    line = torch.zeros((v, length), dtype=prec.dtype)
    for s in range(0, n, length):
        e = min(n, s + length)
        m = e - s
        read = line[:, :m]
        xb = x[:, s:e]
        out[:, s:e] = read - xb
        wrote = xb + read * 0.5
        line = torch.cat([line[:, m:], wrote], 1) if m < length else wrote
    return out


def freeverb(prec, params, ins, v, n, sr):
    """Per channel 8 parallel combs summed, then 4 allpasses in series; the
    right channel's lines 23 samples longer (before the rate scaling)."""
    dt = prec.dtype

    def p(k):
        return _col(prec, params[k])
    frozen = torch.from_numpy(np.asarray(params["freeze"], bool)
                              .reshape(-1, 1))
    damp = torch.where(frozen, torch.tensor(0.0, dtype=dt),
                       p("dampening") * 0.4)
    feed = torch.where(frozen, torch.tensor(1.0, dtype=dt),
                       p("room_size") * 0.28 + 0.7)
    gain = torch.where(frozen, torch.tensor(0.0, dtype=dt),
                       torch.tensor(0.015, dtype=dt))
    wet = p("wet") * 3.0
    width = p("width")
    wet1 = wet * (width / 2.0 + 0.5)
    wet2 = wet * ((1.0 - width) / 2.0)
    dry = p("dry")
    zero = _zeros(prec, v, n)
    left = torch.broadcast_to(ins.get("Left", zero), (v, n))
    right = torch.broadcast_to(ins.get("Right", zero), (v, n))
    mixed = (left + right) * gain
    chans = []
    for extra in (0, SPREAD):
        acc = zero
        for t in COMBS:
            acc = acc + _comb(prec, mixed, _scaled(t + extra, sr), damp, feed)
        for t in ALLPASSES:
            acc = _allpass(prec, acc, _scaled(t + extra, sr))
        chans.append(acc)
    out_l, out_r = chans
    fl = out_l * wet1 + out_r * wet2 + left * dry
    fr = out_r * wet1 + out_l * wet2 + right * dry
    return {0: fl, "Left": fl, 1: fr, "Right": fr}


MODULES = {
    "Oscillator": oscillator,
    "Multiply": multiply,
    "VCA": vca,
    "Moog Filter": moog_filter,
    "ADSR": adsr,
    "Freeverb": freeverb,
}
