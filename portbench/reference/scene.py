"""The reference's part of a physics scene's block that the play cells do not need, in plain
NumPy and plain PyTorch, written from the semantics the program states:

- `mass_properties`: a body's mass, centre of mass and inertia tensor from its tets;
- `contact_time`: the Hertz contact time of an impact (synth/contact.py), tau = 2.87
  ((m* / E*)^2 kappa / v)^(1/5) clamped to [2e-5, 5e-2] s, with m* the reduced mass of
  the struck body at the struck point along the impact direction (its translational and
  rotational response, plus the impactor's inverse mass), 1/E* the two materials'
  compliances summed, and kappa the combined curvature floored at 1e-6 (flat sides);
- `strikes`: a step's impact reports as the bridge turns them into strikes
  (physics/bridge.py `on_impacts`): reports under 0.2 kg m/s or 0.1 m/s dropped; each
  audible side struck at its sample point nearest the contact point, with the impulse
  along the report's direction and its own contact time (the other side, or the floor,
  taken as the impactor with the report's other inverse mass);
- `render_block`: synth.py's block, with each voice's own carries. synth.py takes one age
  for every voice and reads the previous track height anew at the current rate, which
  holds for voices that open together and keep their constants (the play cells); a
  scene's voices open at different blocks and are republished every block with new sweep
  rates, so here each voice carries its age, its last track heights, its relief mean and
  its penetration, as the program's voice table does.
"""

from __future__ import annotations

import numpy as np
import torch

from . import synth as ref_synth

MIN_CONTACT_TIME, MAX_CONTACT_TIME = 2e-5, 5e-2
FLAT_CURVATURE = 1e-6
MIN_CONTACT_IMPULSE, MIN_CONTACT_SPEED = 0.2, 0.1  # the program's ModalSoundControls


def compliance(material: dict) -> float:
    """(1 - nu^2) / E of a material dict (young, poisson)."""
    return (1 - material["poisson"] ** 2) / material["young"]


def mass_properties(points, tets, density: float, dtype=np.float64) -> dict:
    """A body's rigid mass properties from its tets (an unscaled body, in metres): each
    tet's volume lumped in quarters at its corners, as upstream's ComputeMassProperties
    does. Returns the mass, the centre of mass and the inertia tensor about it."""
    x = np.asarray(points, np.float64).astype(dtype)
    tets = np.asarray(tets, np.int64)
    r = x[tets[:, 1:]] - x[tets[:, :1]]
    vol = np.abs(np.einsum("ei,ei->e", r[:, 0], np.cross(r[:, 1], r[:, 2]))) / 6
    w = np.zeros(len(x), dtype)
    np.add.at(w, tets.ravel(), np.repeat(vol / 4, 4))
    total = w.sum()
    com = (w[:, None] * x).sum(0) / total
    d = x - com
    inertia = (w * (d * d).sum(1)).sum() * np.eye(3, dtype=dtype) - \
        np.einsum("n,ni,nj->ij", w, d, d)
    return {"mass": float(density * total), "center_of_mass": com.astype(np.float64),
            "inertia": (density * inertia).astype(np.float64)}


def inverse_inertia(mass_props: dict) -> np.ndarray:
    """The inverse of a body's inertia tensor (mass_properties's)."""
    return np.linalg.inv(np.asarray(mass_props["inertia"], np.float64))


def contact_time(body: dict, expos: int, direction, speed: float, inv_e: float,
                 impactor_inv_mass: float) -> float:
    """The Hertz contact time of `body` (a dict: mass, inv_inertia, arm (P, 3) sample
    points less the centre of mass) struck at sample point `expos`."""
    n = np.asarray(direction, np.float64)
    n = n / np.linalg.norm(n)
    arm_n = np.cross(body["arm"][expos], n)
    m_eff = 1.0 / (1.0 / body["mass"] + arm_n @ body["inv_inertia"] @ arm_n
                   + impactor_inv_mass)
    tau = 2.87 * ((m_eff * inv_e) ** 2 * (FLAT_CURVATURE / max(abs(speed), 1e-6))) ** 0.2
    return float(np.clip(tau, MIN_CONTACT_TIME, MAX_CONTACT_TIME))


def strikes(impacts, audible: dict) -> list:
    """Strikes (obj, expos, impulse (3,), tau, accel 0) of impact reports (dicts: body_a,
    body_b, point, direction, impulse, speed, other_inv_mass). `audible` maps a body to a
    dict: obj (bank slot), positions (P, 3), material, mass, inv_inertia, arm; bodies not
    in it (the floor) make no sound and strike as their partner's material."""
    out = []
    for imp in impacts:
        if imp["impulse"] < MIN_CONTACT_IMPULSE or imp["speed"] < MIN_CONTACT_SPEED:
            continue
        for me, other in ((imp["body_a"], imp["body_b"]), (imp["body_b"], imp["body_a"])):
            body = audible.get(me)
            if body is None:
                continue
            partner = audible.get(other, body)
            point = np.asarray(imp["point"], np.float64)
            expos = int(np.argmin(((body["positions"] - point[None]) ** 2).sum(1)))
            inv_e = compliance(body["material"]) + compliance(partner["material"])
            tau = contact_time(body, expos, imp["direction"], imp["speed"], inv_e,
                               imp["other_inv_mass"])
            out.append((body["obj"], expos,
                        np.asarray(imp["direction"], np.float64) * imp["impulse"], tau, 0.0))
    return out


def render_block(tab: ref_synth.Tables, z_re, z_im, strikes, carries: dict, n: int):
    """Advance the scene n samples from state (z_re, z_im) with the live `strikes`
    (synth.strike_state tuples) and the voices of `tab`, each from its carry in `carries`
    {voice_id: (age, last heights (4,), relief_mean, penetration)}; a voice with no carry
    opens here (age 0, not primed). Returns (out (n,) float64, z_re, z_im, carries after)."""
    dt, sr = tab.dtype, tab.sr
    zr = torch.as_tensor(np.asarray(z_re, np.float64)[:, :tab.n_modes], dtype=dt)
    zi = torch.as_tensor(np.asarray(z_im, np.float64)[:, :tab.n_modes], dtype=dt)
    s_idx = np.arange(n)
    excite = torch.zeros(n, tab.n_obj, tab.n_modes, dtype=dt)
    click = np.zeros(n)
    for obj, expos, impulse, step, gamma, total, accel, age in strikes:
        force = ref_synth._force(step, gamma, total, age + 1 + s_idx)
        prev = ref_synth._force(step, gamma, total, np.array([age]))[0]
        click += accel * np.diff(np.concatenate([[prev], force]))
        gain = tab.shapes[obj, expos] @ impulse
        excite[:, obj] += tab.cast(force)[:, None] * tab.cast(gain)[None, :]
    vs = tab.voices
    rows, last = [], []
    for v in vs:
        carry = carries.get(v["voice_id"])
        age = carry[0] if carry is not None else 0
        heights = ref_synth._track_heights(tab, v, age + 1 + s_idx)
        relief = heights.sum(0)
        prev = np.asarray(carry[1], np.float64) if carry is not None else np.zeros(4)
        steps32 = np.array([t[4] for t in v["tracks"]], np.float64).astype(np.float32)
        steps32 = steps32.astype(np.float64)
        d = np.diff(np.concatenate([prev[:, None], heights], 1), axis=1)
        terms = np.where(steps32[:, None] > 0,
                         d / np.where(steps32 > 0, steps32, 1.0)[:, None], 0.0)
        if carry is None:
            terms[:, 0] = 0.0
        rm, pen = (carry[2], carry[3]) if carry is not None else \
            (relief[0], max(v["static_pen"], 0.0))
        blend = tab.shapes[v["obj"], v["expos"]]  # (K, 3)
        g_n = blend @ v["normal"]
        scale = 1.0 / sr
        rows.append(dict(
            obj=v["obj"], relief=relief, slope0=terms[0] + terms[2], slope1=terms[1] + terms[3],
            alpha=min(steps32.max() / ref_synth.RELIEF_DC_LENGTH, 1.0), rm=rm, pen=pen,
            gnf=tab.cast(scale * (g_n + v["friction"] * (blend @ v["slip"]))),
            geo0=tab.cast(scale * (blend @ v["sweep"][0])),
            geo1=tab.cast(scale * (blend @ v["sweep"][1])),
            read=tab.cast(g_n * tab.disp[v["obj"]])))
        last.append((age + n, heights[:, -1].copy()))
    if rows:
        vobj = torch.as_tensor([r["obj"] for r in rows])
        read, gnf, geo0, geo1 = (torch.stack([r[k] for r in rows])
                                 for k in ("read", "gnf", "geo0", "geo1"))
        vx = tab.cast(np.stack([np.stack([r["relief"], r["slope0"], r["slope1"]]) for r in rows]))
        alpha, rm, pen = (tab.cast([r[k] for r in rows]) for k in ("alpha", "rm", "pen"))
        sp, stiff, damp, nf = (tab.cast([v[k] for v in vs]) for k in
                               ("static_pen", "stiffness", "damping", "normal_force"))
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
    live = np.zeros(tab.n_obj, bool)
    for obj, _e, _i, _s, _g, total, _a, age in strikes:
        live[obj] |= age + n < total
    for v in vs:
        live[v["obj"]] = True
    energy = (zr.double() ** 2 + zi.double() ** 2).sum(1) * tab.gains.double() ** 2
    keep = torch.as_tensor(~((energy.numpy() < ref_synth.SILENT_ENERGY) & ~live),
                           dtype=dt)[:, None]
    zr, zi = zr * keep, zi * keep
    carried = {v["voice_id"]: (a, h, float(rm[i]), float(pen[i]))
               for i, (v, (a, h)) in enumerate(zip(vs, last))}
    return out.double().numpy() + click, zr.double().numpy(), zi.double().numpy(), carried
