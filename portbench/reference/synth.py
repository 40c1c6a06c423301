"""Plain PyTorch reference of the modal render, run on the CPU in float64 (its control in
bfloat16), written from the semantics the program states and not from its code:

- each mode a complex one-pole resonator, c = 0.001^(1/(T60 sr)) e^(i 2 pi f / sr), muted
  at or above sr/2 - 1; the output the sum over objects of gain times Im z;
- each strike a half-sine force gamma sin(pi step a) over ages a = 1..ceil(1/step), driving
  its object's modes through the struck point's shapes projected on the impulse, plus its
  acceleration click (accel_amp times the force's difference);
- each sustained voice a Hunt-Crossley contact: the relief (the sum of four box-filtered
  or interpolated track reads, positions in float64) with its leaky mean removed, the
  separation against the object's own deflection (the read row on the previous sample's
  Im z), force k s^1.5 (1 + c_d ds/dt), the normal load's tanh knee, and the drive
  (normal, plus load times each surface's slope) into Re z after the update;
- after the block, an object whose gain-weighted energy is under 1e-12 with no live strike
  or voice is zeroed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SILENT_ENERGY = 1e-12
RELIEF_DC_LENGTH = 1e-2


class Tables:
    """The bank, the voices and their tracks, in the reference's precision."""

    def __init__(self, bank, gains, sample_rate, voices, tracks, dtype):
        self.dtype, self.sr = dtype, float(sample_rate)
        f = np.stack([b[0] for b in bank]).astype(np.float64)
        t60 = np.stack([b[1] for b in bank]).astype(np.float64)
        ok = np.isfinite(f) & np.isfinite(t60) & (f > 0) & (f < self.sr / 2 - 1) & (t60 > 0)
        f1, t1 = np.where(ok, f, 1.0), np.where(ok, t60, 1.0)
        decay = np.power(1e-3, 1.0 / (t1 * self.sr))
        w = 2 * np.pi * f1 / self.sr
        cast = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
        self.c_re = cast(np.where(ok, decay * np.cos(w), 0.0))
        self.c_im = cast(np.where(ok, decay * np.sin(w), 0.0))
        self.disp = np.where(ok, 1.0 / (2 * np.pi * f1), 0.0)
        self.shapes = np.stack([b[2] for b in bank]).astype(np.float64)  # (O, P, K, 3)
        self.gains = cast(np.asarray(gains, np.float64))
        self.voices = voices
        self.tracks = tracks  # surface tuple -> (heights, sums) float32
        self.n_obj, self.n_modes = f.shape

    def cast(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype)


def strike_state(strike, enqueued_block: int, block: int, block_samples: int, sr: float):
    """A strike (obj, expos, impulse, tau, accel) enqueued before `block`'s render at
    `enqueued_block`: (obj, expos, impulse, step, gamma, total, accel, age at the block's
    start), or None once its pulse has ended."""
    obj, expos, impulse, tau, accel = strike
    step = 1.0 / (tau * sr)
    total = int(np.ceil(1.0 / step))
    age = block_samples * (block - enqueued_block)
    if age >= total and block > enqueued_block:
        return None
    return obj, expos, np.asarray(impulse, np.float64), step, math.pi / 2 * step, total, \
        accel, age


def _force(step, gamma, total, ages):
    live = (ages >= 1) & (ages <= total)
    return np.where(live, gamma * np.sin(np.pi * step * ages), 0.0)


def _track_heights(tab: Tables, v: dict, ages):
    """(4, S) float64 heights of voice v's tracks at absolute ages (samples since the
    voice opened; the i-th track starts a quarter of the track length after the last)."""
    out = np.zeros((4, len(ages)))
    for t, (surf, rate, sigma, window, _step) in enumerate(v["tracks"]):
        if surf is None:
            continue
        h, sums = (a.astype(np.float64) for a in tab.tracks[surf])
        n = len(h)
        pos = t * (n / 4.0) + ages.astype(np.float64) * np.float64(np.float32(rate))

        def wrap(p):
            wraps = np.floor(p / n)
            f = np.maximum(p - wraps * n, 0.0)
            i = np.minimum(f.astype(np.int64), n - 1)
            return i, f - i, wraps

        if np.float32(window) <= 1.0:
            i, frac, _ = wrap(pos)
            j = np.where(i + 1 < n, i + 1, 0)
            val = h[i] + frac * (h[j] - h[i])
        else:
            half = 0.5 * np.float64(np.float32(window))

            def integral(p):
                i, frac, wraps = wrap(p)
                return sums[i] + frac * h[i] + wraps * sums[n]

            val = (integral(pos + half) - integral(pos - half)) / np.float64(np.float32(window))
        out[t] = val * np.float64(np.float32(sigma))
    return out


def render_block(tab: Tables, z_re, z_im, strikes, carries, voice_age: int, n: int):
    """Advance the scene n samples from state (z_re, z_im) with the live `strikes`
    (strike_state tuples) and the voices' carries {voice_id: (relief_mean, penetration)}
    (None for voices that have not rendered yet), the voices `voice_age` samples old.
    Returns (out (n,) float64, z_re, z_im, {voice_id: (relief_mean, penetration)})."""
    dt, sr = tab.dtype, tab.sr
    zr = torch.as_tensor(np.asarray(z_re, np.float64)[:, :tab.n_modes], dtype=dt)
    zi = torch.as_tensor(np.asarray(z_im, np.float64)[:, :tab.n_modes], dtype=dt)
    s_idx = np.arange(n)
    # Strikes: per-sample forces, gain rows, clicks.
    excite = torch.zeros(n, tab.n_obj, tab.n_modes, dtype=dt)
    click = np.zeros(n)
    for obj, expos, impulse, step, gamma, total, accel, age in strikes:
        force = _force(step, gamma, total, age + 1 + s_idx)
        prev = _force(step, gamma, total, np.array([age]))[0]
        click += accel * np.diff(np.concatenate([[prev], force]))
        gain = tab.shapes[obj, expos] @ impulse
        excite[:, obj] += tab.cast(force)[:, None] * tab.cast(gain)[None, :]
    # Voices: the block's precompute.
    vs = tab.voices
    ages = voice_age + 1 + s_idx
    rows = []
    for v in vs:
        heights = _track_heights(tab, v, ages)
        relief = heights.sum(0)
        primed = carries.get(v["voice_id"]) is not None
        prev = _track_heights(tab, v, np.array([voice_age]))[:, 0] if primed else np.zeros(4)
        steps = np.array([tr[4] for tr in v["tracks"]], np.float64)
        steps32 = steps.astype(np.float32).astype(np.float64)
        d = np.diff(np.concatenate([prev[:, None], heights], 1), axis=1)
        terms = np.where(steps32[:, None] > 0, d / np.where(steps32 > 0, steps32, 1.0)[:, None],
                         0.0)
        if not primed:
            terms[:, 0] = 0.0
        alpha = min(steps32.max() / RELIEF_DC_LENGTH, 1.0)
        rm, pen = carries[v["voice_id"]] if primed else (relief[0], max(v["static_pen"], 0.0))
        blend = tab.shapes[v["obj"], v["expos"]]  # (K, 3)
        g_n = blend @ v["normal"]
        scale = 1.0 / sr
        rows.append(dict(
            obj=v["obj"], relief=relief, slope0=terms[0] + terms[2], slope1=terms[1] + terms[3],
            alpha=alpha, rm=rm, pen=pen,
            gnf=tab.cast(scale * (g_n + v["friction"] * (blend @ v["slip"]))),
            geo0=tab.cast(scale * (blend @ v["sweep"][0])),
            geo1=tab.cast(scale * (blend @ v["sweep"][1])),
            read=tab.cast(g_n * tab.disp[v["obj"]])))
    if rows:
        vobj = torch.as_tensor([r["obj"] for r in rows])
        read = torch.stack([r["read"] for r in rows])
        gnf = torch.stack([r["gnf"] for r in rows])
        geo0 = torch.stack([r["geo0"] for r in rows])
        geo1 = torch.stack([r["geo1"] for r in rows])
        vx = tab.cast(np.stack([np.stack([r["relief"], r["slope0"], r["slope1"]]) for r in rows]))
        alpha = tab.cast([r["alpha"] for r in rows])
        rm = tab.cast([r["rm"] for r in rows])
        pen = tab.cast([r["pen"] for r in rows])
        sp = tab.cast([v["static_pen"] for v in vs])
        stiff = tab.cast([v["stiffness"] for v in vs])
        damp = tab.cast([v["damping"] for v in vs])
        nf = tab.cast([v["normal_force"] for v in vs])
        srt = tab.cast(sr)
    out = torch.zeros(n, dtype=dt)
    for t in range(n):
        if rows:
            defl = (read * zi[vobj]).sum(1)
            relief, slope0, slope1 = vx[:, 0, t], vx[:, 1, t], vx[:, 2, t]
            rm = rm + (relief - rm) * alpha
            sep = (sp + (relief - rm) - defl).clamp_min(0)
            rate = (sep - pen) * srt
            force = (stiff * sep * torch.sqrt(sep) * (1 + damp * rate)).clamp_min(0)
            normal = force - nf
            knee = (normal > 0) & (nf > 0)
            normal = torch.where(knee, nf * torch.tanh(normal / torch.where(nf > 0, nf, 1)),
                                 normal)
            load = nf + normal
            pen = sep
            drive = (normal[:, None] * gnf + (load * slope0)[:, None] * geo0
                     + (load * slope1)[:, None] * geo1)
        new_re = zr * tab.c_re - zi * tab.c_im + excite[t]
        new_im = zr * tab.c_im + zi * tab.c_re
        if rows:
            new_re = new_re.index_add(0, vobj, drive)
        zr, zi = new_re, new_im
        out[t] = (tab.gains[:, None] * zi).sum()
    # After the block: objects fallen silent with nothing live on them are zeroed.
    live = np.zeros(tab.n_obj, bool)
    for obj, _e, _i, _s, _g, total, _a, age in strikes:
        live[obj] |= age + n < total
    for v in vs:
        live[v["obj"]] = True
    energy = (zr.double() ** 2 + zi.double() ** 2).sum(1) * tab.gains.double() ** 2
    keep = torch.as_tensor(~((energy.numpy() < SILENT_ENERGY) & ~live), dtype=dt)[:, None]
    zr, zi = zr * keep, zi * keep
    carried = {}
    if rows:
        carried = {v["voice_id"]: (float(rm[i]), float(pen[i])) for i, v in enumerate(vs)}
    return (out.double().numpy() + click, zr.double().numpy(), zi.double().numpy(), carried)
