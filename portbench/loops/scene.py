"""Loop kind `scene`: a physics scene that sounds, played block by block through the
program's scene stepper (mesheditor_tpu_torch/scene/audio_sync.py `SceneSimulation`).
The configuration holds the scene (a floor, the bodies, their surfaces, materials, solve
settings and colliders, the physics constants, the throw's layout); the traffic plays
back-to-back drop episodes: each re-throws the bodies from the seed (positions, velocities
and spins drawn as the layout says), restarts the stepper at the new throw, and plays
`episode_blocks` blocks. A unit is one block: its physics steps, the bridge, the voice
publish, the render and the host copy; an episode's restart is timed with its first block.

Set-up solves the bodies into a fresh store (the stepper's reconcile, as a user's first load
of the scene), plays one episode of a warm-up throw that no window episode gets, then
starts the window's stepper over the stored models (nothing solved), so the window's bank
starts from rest.

The check, after the window, from the program's own state:
- models: each body kind meshed by the reference mesher and solved by the reference FEM
  (reference/sparse_fem.py) at the configuration's settings, as reconcile solves it;
  every body's model against its kind's (`modes` exact, `freq_rel`, `t60_rel`, `gain_rel`
  per cluster as the solve cells compare) and its mass, centre of mass and inertia against
  the reference's, lumped from the reference's tets (`mass_rel`);
- physics: on the window's first `start_steps` steps, each episode's first step that
  reports an impact, and up to `sampled_steps` later ones drawn from the seed, the
  reference's step (reference/physics.py, float64) from the
  program's state before the step, against the program's state after it (`pose_rel`,
  `vel_rel`), its impulses (`impulse_rel`) and its impact and sustained report sets
  (`reports`, exact);
- voices: on the checked blocks, the voice constants the reference bridge derives from the
  program's sustained reports against the set the program published (`voice_rel`);
- blocks: on the window's first `start_blocks` blocks, the block of each episode's first
  impact, each episode's first voiced block and its first voiced block in the episode's
  second half, and up to `sampled_blocks` later ones drawn from the seed, the reference's
  render (reference/scene.py, float64) from the program's bank state
  and voice carries before the block, with the reference's strikes of the program's impact
  reports and the reference's voices, against the block's samples (`block_rel`) and the
  bank state after it (`state_rel`). A voiced block where a contact chatters at its clamp
  is left out of these two and named on standard error: there a float32 render of the
  reference, or one from a state and voices nudged by a float32 rounding, already lies
  more than CONDITION from its float64 render, so the samples follow any rounding.
  The blocks render from the program's models, once held to the reference's, and strike
  with the reference's mass properties;
- coverage: a run in which no checked step reports an impact, or no held block has an
  impact or a voice, fails (`coverage_gaps`, the count of those missing; limit 0).
"""

from __future__ import annotations

import sys
import tempfile
import time
from collections import Counter

import numpy as np

from portbench import harness, inputs
from portbench.harness import Check, Run
from portbench.reference import bridge as ref_bridge
from portbench.reference import compare, fem, mesher, sparse_fem
from portbench.reference import physics as ref_physics
from portbench.reference import scene as ref_scene
from portbench.reference import synth as ref_synth
from portbench.window import closed_loop, memory_peak

play_loop = harness.load_module("loops", "play")

THROW = 6  # the seed's sub-stream of episode throws (inputs.py uses 0-5)
LOOKBACK = 5  # blocks a strike's pulse may last (a contact time of 5e-2 s at most)
PHYSICS_CHECKS = ("pose_rel", "vel_rel", "impulse_rel", "reports")
MODEL_CHECKS = ("modes", "freq_rel", "t60_rel", "gain_rel", "mass_rel")
EPS32 = 2.0 ** -23  # a float32 rounding, relative
# A voiced block is held to block_rel and state_rel only where a float32 render of the
# reference, and one from a state and voices nudged by EPS32, lie within this of its float64
# render: elsewhere a contact chatters at its clamp and the samples follow any rounding.
CONDITION = 3e-4


# ---- the scene, from the configuration ----

def kinds(cfg) -> list:
    """Each body's kind (a key of cfg["scene"]), in body order."""
    sc = cfg["scene"]
    return [sc["kinds"][i % len(sc["kinds"])] for i in range(sc["bodies"])]


def bodies(cfg) -> list:
    """The reference's scene: the floor first, then the bodies in order (the program's
    handle order)."""
    sc, ph = cfg["scene"], cfg["physics"]
    floor = sc["floor"]
    common = dict(restitution=ph["restitution"], friction=ph["friction"],
                  linear_damping=ph["linear_damping"], angular_damping=ph["angular_damping"])
    out = [ref_physics.Body("plane", (*floor["normal"], floor["offset"]), **common)]
    for kind in kinds(cfg):
        k = sc[kind]
        size = (k["radius"],) if k["collider"] == "sphere" else tuple(k["half_extents"])
        out.append(ref_physics.Body(k["collider"], size, k["mass"], **common))
    return out


def throw(seed: int, episode: int, cfg) -> list:
    """The bodies' (position, velocity, spin) of an episode (negative: warm-up's): body i at
    x = x0 + spacing i, with y, z, the velocity and the spin drawn from the seed; the first
    body at `first_y_m`, at rest."""
    lay = cfg["layout"]
    g = inputs.rng(seed, THROW, episode)
    out = []
    for i in range(cfg["scene"]["bodies"]):
        position = np.array([lay["spacing_m"] * i + lay["x0_m"], g.uniform(*lay["y_m"]),
                             g.uniform(*lay["z_m"])])
        velocity = np.array([g.uniform(*lay["vx_mps"]), g.uniform(*lay["vy_mps"]),
                             g.uniform(*lay["vz_mps"])])
        spin = g.normal(0.0, lay["spin_radps"], 3)
        if i == 0:
            position[1], velocity, spin = lay["first_y_m"], np.zeros(3), np.zeros(3)
        out.append((position, velocity, spin))
    return out


def surface(kind: dict):
    """A body kind's closed surface, from the program's mesh primitives."""
    from mesheditor_tpu_torch.mesh import grid_box_surface, icosphere_surface

    s = kind["surface"]
    if s["kind"] == "icosphere":
        pts, tris = icosphere_surface(s["subdivisions"])
        return pts * s["scale"], tris
    pts, tris = grid_box_surface(s["segments"])
    return (pts - 0.5) * 2.0 * np.asarray(kind["half_extents"]), tris


def registry(cfg):
    """The program's registry of the scene: (registry, the bodies' entities)."""
    from mesheditor_tpu_torch.scene import components as c
    from mesheditor_tpu_torch.scene.registry import Registry

    sc = cfg["scene"]
    reg = Registry()
    floor = reg.create()
    reg.emplace(floor, c.RigidBodyComponent(
        shape_kind="plane", plane_normal=np.asarray(sc["floor"]["normal"], np.float64),
        plane_offset=float(sc["floor"]["offset"])))
    ents = []
    for kind in kinds(cfg):
        k, e = sc[kind], reg.create()
        pts, tris = surface(k)
        m = cfg["materials"][k["material"]]
        reg.emplace(e, c.MeshSurface(positions=pts, triangles=tris))
        reg.emplace(e, c.AcousticMaterialRef(
            name=k["material"], density=m["density"], young_modulus=m["young"],
            poisson_ratio=m["poisson"], alpha=m["alpha"], beta=m["beta"]))
        reg.emplace(e, c.SolveSettingsComponent(**cfg["settings"]))
        reg.emplace(e, c.Transform())
        reg.emplace(e, c.RigidBodyComponent(
            shape_kind=k["collider"], radius=k.get("radius", 0.5),
            half_extents=np.asarray(k.get("half_extents", (0.5, 0.5, 0.5)), np.float64),
            is_dynamic=True, mass=k["mass"]))
        ents.append(e)
    return reg, ents


def place(reg, ents, thrown) -> None:
    """Set the bodies' Transform and velocities to a throw."""
    from mesheditor_tpu_torch.scene import components as c

    for e, (p, v, w) in zip(ents, thrown):
        reg.emplace(e, c.Transform(translation=p.copy()))
        rb = reg.get(e, c.RigidBodyComponent)
        rb.linear_velocity, rb.angular_velocity = v.copy(), w.copy()


# ---- the program's state, in the reference's terms ----

def world_state(world) -> ref_physics.State:
    """The world's bodies in handle order (handle h is body h - 1) and its touching pairs."""
    bs = [world.bodies[h] for h in sorted(world.bodies)]
    touching = frozenset((min(s.body_a, s.body_b) - 1, max(s.body_a, s.body_b) - 1)
                         for s in world.sustained.values())
    return ref_physics.State(np.array([b.pos for b in bs]), np.array([b.quat for b in bs]),
                             np.array([b.vel for b in bs]), np.array([b.ang for b in bs]),
                             touching)


def impact_dicts(impacts) -> list:
    return [dict(body_a=m.body_a - 1, body_b=m.body_b - 1, point=np.asarray(m.point),
                 direction=np.asarray(m.direction), impulse=float(m.impulse),
                 speed=float(m.speed), other_inv_mass=float(m.other_inv_mass))
            for m in impacts]


def sustained_dicts(sustained) -> dict:
    keys = ("point", "normal", "normal_force", "slip_speed", "sweep_speed_a", "sweep_speed_b",
            "friction", "restitution")
    return {(min(s.body_a, s.body_b) - 1, max(s.body_a, s.body_b) - 1):
            dict(body_a=s.body_a - 1, body_b=s.body_b - 1, **{k: getattr(s, k) for k in keys})
            for s in sustained.values()}


def audible(cfg, models: list, masses: list) -> dict:
    """{body index: what the bridge strikes and voices it with} for the bodies (index 1...,
    bank slot index - 1), from the models' sample points and the reference's mass
    properties (reference/scene.py mass_properties)."""
    out = {}
    for slot, (kind, m, mp) in enumerate(zip(kinds(cfg), models, masses)):
        pos = np.asarray(m["positions"], np.float64)
        out[slot + 1] = dict(obj=slot, positions=pos,
                             material=cfg["materials"][cfg["scene"][kind]["material"]],
                             mass=mp["mass"], inv_inertia=ref_scene.inverse_inertia(mp),
                             arm=pos - np.asarray(mp["center_of_mass"], np.float64))
    return out


def snapshot(synth) -> dict:
    """The bank's (O, K) state and each live voice's carries by voice id."""
    v = synth.voices
    age, prev = v.age.cpu().numpy(), v.prev_height.cpu().numpy()
    rm, pen, primed = (v.relief_mean.cpu().numpy(), v.penetration.cpu().numpy(),
                       v.primed.cpu().numpy())
    return {"z_re": synth.state.z_re.cpu().numpy(), "z_im": synth.state.z_im.cpu().numpy(),
            "carries": {vid: (int(age[r]), prev[r].astype(np.float64), float(rm[r]),
                              float(pen[r]))
                        for vid, r in synth._voice_ids.items() if primed[r]}}


# ---- the comparisons ----

def _report_gap(a: list, b: list) -> int:
    if a == b:
        return 0
    ca, cb = Counter(a), Counter(b)
    return max(1, sum(((ca - cb) + (cb - ca)).values()))


def step_gaps(got, want) -> dict:
    """The physics checks of one step: `got` and `want` are (State, impacts, sustained)."""
    (gs, gi, gu), (ws, wi, wu) = got, want
    reports = _report_gap([(m["body_a"], m["body_b"]) for m in gi],
                          [(m["body_a"], m["body_b"]) for m in wi]) + \
        _report_gap(list(gu), list(wu))
    impulse = float("inf")
    if not reports:
        impulse = max(compare.rel_gap(np.array([m["direction"] * m["impulse"] for m in gi]),
                                      np.array([m["direction"] * m["impulse"] for m in wi])),
                      compare.rel_gap([s["normal_force"] for s in gu.values()],
                                      [s["normal_force"] for s in wu.values()]))
    return {"pose_rel": compare.rel_gap(np.concatenate([gs.pos, gs.quat], 1),
                                        np.concatenate([ws.pos, ws.quat], 1)),
            "vel_rel": compare.rel_gap(np.concatenate([gs.vel, gs.ang], 1),
                                       np.concatenate([ws.vel, ws.ang], 1)),
            "impulse_rel": impulse, "reports": reports}


def reference_step(cfg, scene, state, dtype=np.float64):
    ph = cfg["physics"]
    return ref_physics.step(scene, state, ph["dt"], ph["gravity"], ph["solver_iterations"],
                            dtype)


def ref_voices(cfg, sustained: dict, aud: dict, sample_rate: float) -> list:
    """The reference bridge's voice set of a step's sustained contacts (dicts by pair): each
    contact's two audible sides, its materials' compliances summed (the floor taken as its
    partner's material), at most MAX_VOICES in report order."""
    surf = tuple(cfg["play"]["surface"])
    out = []
    for (i, k), s in sustained.items():
        a, b = aud.get(s["body_a"]), aud.get(s["body_b"])
        inv_e = ref_scene.compliance((a or b)["material"]) + \
            ref_scene.compliance((b or a)["material"])
        contact = dict(s, contact_id=ref_physics.contact_id(i, k),
                       body_a=a["obj"] if a else -1, body_b=b["obj"] if b else -1)
        # bridge.voices takes one material for both sides: one whose compliance, counted
        # twice, is the pair's.
        voices = ref_bridge.voices(
            [contact], {"poisson": 0.0, "young": 2.0 / inv_e}, lambda _o: surf,
            lambda o: aud[o + 1]["positions"] if o >= 0 else np.zeros((1, 3)), sample_rate)
        out += [v for v in voices if v["obj"] >= 0]
    return out[:ref_bridge.MAX_VOICES]


def tables(models: list, gains: list, sample_rate: float, voices: list, surf, dtype,
           tracks: dict):
    """The reference's tables of the bank (each model padded to the widest) and voices."""
    kmax = max(len(m["freqs"]) for m in models)
    pmax = max(m["shapes"].shape[0] for m in models)
    bank = []
    for m in models:
        k, p = len(m["freqs"]), m["shapes"].shape[0]
        bank.append((np.pad(np.asarray(m["freqs"], np.float64), (0, kmax - k)),
                     np.pad(np.asarray(m["t60s"], np.float64), (0, kmax - k),
                            constant_values=1.0),
                     np.pad(m["shapes"], ((0, pmax - p), (0, kmax - k), (0, 0)))))
    if voices and tuple(surf) not in tracks:
        tracks[tuple(surf)] = ref_bridge.roughness(surf[1], surf[2], surf[3])
    return ref_synth.Tables(bank, gains, sample_rate, voices, tracks, dtype)


def live_strikes(b: int, strikes_of, n: int, sr: float) -> list:
    out = []
    for e in range(max(0, b - LOOKBACK), b + 1):
        for s in strikes_of(e):
            st = ref_synth.strike_state(s, e, b, n, sr)
            if st is not None:
                out.append(st)
    return out


def block_gaps(tabs, before: dict, after: dict, out, live, n: int):
    """(block gap, state gap) of one block against the reference's render from `before`, or
    None where the block is ill-conditioned. `tabs` holds the float64 tables, the float32
    ones and float64 ones of voices nudged by EPS32; the block is ill-conditioned where the
    float32 render, or the float64 render from the nudged voices and state, lies further
    than CONDITION from the float64 render (a contact chattering on the edge of its
    clamp: the samples then follow any rounding, the program's or the reference's)."""
    tab, tab32, nudged = tabs

    def render(t, start):
        r_out, r_re, r_im, _ = ref_scene.render_block(t, start["z_re"], start["z_im"], live,
                                                      start["carries"], n)
        return r_out, r_re, r_im

    def gaps(got_out, got_re, got_im, want):
        r_out, r_re, r_im = want
        k = r_re.shape[1]
        pad = np.abs(got_re[:, k:]).max(initial=0) + np.abs(got_im[:, k:]).max(initial=0)
        state = compare.rel_gap(np.concatenate([got_re[:, :k], got_im[:, :k]]),
                                np.concatenate([r_re, r_im])) + (float("inf") if pad else 0)
        return compare.rel_gap(got_out, r_out), state

    want = render(tab, before)
    if tab.voices:
        moved = dict(before, z_re=before["z_re"] * (1 + EPS32),
                     z_im=before["z_im"] * (1 + EPS32))
        spread = max(*gaps(*render(tab32, before), want), *gaps(*render(nudged, moved), want))
        if spread > CONDITION:
            return None
    return gaps(out, after["z_re"], after["z_im"], want)


def block_tables(models, gains, sr: float, voices: list, surf, tracks: dict) -> tuple:
    """The float64 tables of a block, the float32 ones, and float64 ones of the voices'
    loads and static penetrations nudged by EPS32."""
    import torch

    nudged = [dict(v, normal_force=v["normal_force"] * (1 + EPS32),
                   static_pen=v["static_pen"] * (1 + EPS32)) for v in voices]
    return (tables(models, gains, sr, voices, surf, torch.float64, tracks),
            tables(models, gains, sr, voices, surf, torch.float32, tracks),
            tables(models, gains, sr, nudged, surf, torch.float64, tracks))


def bank_of(sa, ents) -> tuple:
    """The solved models, their bank gains and their mass properties (mass, centre of mass
    and inertia tensor), in slot order."""
    models, gains, masses = [], [], []
    for e in ents:
        live = sa._live[e]
        m = live.modes
        models.append({"freqs": np.asarray(m.freqs, np.float64),
                       "t60s": np.asarray(m.t60s, np.float64), "positions": m.positions,
                       "shapes": np.asarray(m.shapes, np.float64)})
        gains.append(sa.modal_level / max(m.num_modes, 1) * 1e3)
        mp = live.mass
        w, x, y, z = mp.inertia_orientation
        r = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        masses.append({"mass": float(mp.mass),
                       "center_of_mass": np.asarray(mp.center_of_mass, np.float64),
                       "inertia": r @ np.diag(mp.inertia_diagonal) @ r.T})
    return models, gains, masses


def reference_solves(cfg, dtype=np.float64) -> dict:
    """{kind: (model, mass properties)}: each body kind's surface meshed by the reference
    mesher at bbox / tet_resolution and solved by the reference FEM at the configuration's
    settings, as the editor's reconcile solves an unscaled body with no sound vertices: the
    excitation at `num_vertices` surface vertices evenly spaced through the list,
    max(num_modes + 15, 3 num_modes / 2) pairs solved; the mass properties lumped from the
    same tets."""
    st = cfg["settings"]
    if st["solve_resolution"] != 1.0 or st["quality_tets"]:
        raise ValueError("the reference meshes the surface as given, with no quality bound")
    out = {}
    for kind in sorted(set(kinds(cfg))):
        k = cfg["scene"][kind]
        mat = cfg["materials"][k["material"]]
        pts, tris = surface(k)
        span = float((pts.max(0) - pts.min(0)).max())
        tet_pts, tets = mesher.delaunay(pts, tris, span / cfg["tet_resolution"])
        excite = pts[np.linspace(0, len(pts) - 1, st["num_vertices"]).astype(int)]
        n = st["num_modes"]
        model = sparse_fem.solve_modes(tet_pts, tets, mat, excite, n, max(n + 15, n * 3 // 2),
                                       st["min_mode_freq"], st["max_mode_freq"], dtype)
        model["positions"] = tet_pts[fem.nearest_vertices(tet_pts, excite)]
        print(f"portbench: reference solve of {kind}: {model['dofs']} dofs, "
              f"{len(model['freqs'])} modes from {model['freqs'][0]:.3f} Hz, "
              f"{sparse_fem.lowest_pairs.last}", file=sys.stderr, flush=True)
        out[kind] = (model, ref_scene.mass_properties(tet_pts, fem.keep_elements(tet_pts, tets),
                                                      mat["density"], dtype))
    return out


def model_gaps(cfg, models: list, masses: list, refs: dict) -> dict:
    """The model checks of every body against its kind's reference solve, the largest of
    each: the mode count's gap, the frequencies', the T60s', the per-cluster gain sums'
    (compare.py), and `mass_rel`: the mass's, the centre of mass's over the radius of
    gyration, and the inertia tensor's over its largest entry."""
    worst = dict.fromkeys(MODEL_CHECKS, 0.0)
    for kind, m, mp in zip(kinds(cfg), models, masses):
        ref, rp = refs[kind]
        n = min(len(m["freqs"]), len(ref["freqs"]))
        gaps = {"modes": abs(len(m["freqs"]) - len(ref["freqs"])),
                "freq_rel": compare.freq_rel(m, ref), "t60_rel": float("inf"),
                "gain_rel": float("inf")}
        if n:
            gaps["t60_rel"] = float((np.abs(m["t60s"][:n] - ref["t60s"][:n])
                                     / ref["t60s"][:n]).max())
            if m["shapes"].shape[0] == ref["shapes"].shape[0]:
                gaps["gain_rel"] = compare.gain_rel(m["shapes"][:, :n], ref["shapes"][:, :n],
                                                    ref["freqs"][:n])
        gyration = np.sqrt(np.trace(rp["inertia"]) / rp["mass"])
        gaps["mass_rel"] = max(abs(mp["mass"] - rp["mass"]) / rp["mass"],
                               float(np.abs(mp["center_of_mass"] - rp["center_of_mass"]).max()
                                     / gyration),
                               compare.rel_gap(mp["inertia"], rp["inertia"]))
        worst = {k: max(worst[k], gaps[k] if np.isfinite(gaps[k]) else float("inf"))
                 for k in worst}
    return worst


# ---- the run ----

def run(ctx):
    # The stepper first: a program that lacks it fails here, at once.
    from mesheditor_tpu_torch.scene.audio_sync import SceneSimulation

    import torch

    from mesheditor_tpu_torch import _build, profile

    cfg, tr, seed, dev = ctx.config, ctx.traffic, ctx.seed, ctx.device
    play, ph = cfg["play"], cfg["physics"]
    sr, n = float(play["sample_rate"]), int(play["block"])
    if dev == "cuda":
        _build.load_kernels()
    reg, ents = registry(cfg)
    place(reg, ents, throw(seed, -1, cfg))
    with tempfile.TemporaryDirectory(prefix="portbench_scene_") as store:
        args = (store, sr, n, tuple(ph["gravity"]), cfg["tet_resolution"])
        warm = SceneSimulation(reg, *args, device=dev)  # the solves
        for _ in range(tr["warm_blocks"]):
            warm.block().cpu().numpy()
        del warm
        sim = SceneSimulation(reg, *args, device=dev)  # the stored models, a bank at rest
    # Handle h is reference body h - 1: the floor's 1, the bodies' 2, 3, ... in order.
    assert [sim.handles[e] for e in ents] == list(range(2, len(ents) + 2)), sim.handles
    assert abs(sim.world.dt - ph["dt"]) < 1e-15, sim.world.dt
    if dev == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start

    sampler = inputs.rng(seed, inputs.SAMPLE)
    episode = tr["episode_blocks"]
    block_snaps, step_snaps, block_impacts = {}, [], []
    # The world's state before the next step; steps so far; the episode's first impact
    # seen; its voiced blocks kept; the steps and blocks drawn from the seed so far.
    now = {"state": None, "step": 0, "struck": False, "voiced": 0, "steps_drawn": 0,
           "blocks_drawn": 0}

    def drawn(key: str, most: int, every: float) -> bool:
        if now[key] < most and sampler.random() < every:
            now[key] += 1
            return True
        return False

    def on_step():
        impacts = sim.world.impacts
        block_impacts[-1].extend(impacts)
        after = world_state(sim.world)
        k, now["step"] = now["step"], now["step"] + 1
        first = bool(impacts) and not now["struck"]
        now["struck"] |= first
        if first or k < tr["start_steps"] or \
                drawn("steps_drawn", tr["sampled_steps"], tr["step_every"]):
            step_snaps.append((now["state"], after, impact_dicts(impacts),
                               sustained_dicts(sim.world.sustained)))
        now["state"] = after

    def step(b):
        ep, k = divmod(b, episode)
        if k == 0:
            place(reg, ents, throw(seed, ep, cfg))
            now["struck"], now["voiced"] = False, 0
        before, struck = snapshot(sim.audio.synth), now["struck"]
        block_impacts.append([])
        t0 = time.perf_counter()
        if k == 0:
            with ctx.spans("play/restart"):
                sim.restart()
            now["state"] = world_state(sim.world)
        with ctx.spans("play/scene"):
            out = sim.block(on_step)
        with ctx.spans("play/copy"):
            host = out.cpu().numpy()
        wall = time.perf_counter() - t0
        voiced = bool(sim.voices) and (now["voiced"] == 0 or
                                       (now["voiced"] == 1 and 2 * k >= episode))
        now["voiced"] += voiced
        if voiced or now["struck"] != struck or b < tr["start_blocks"] or \
                drawn("blocks_drawn", tr["sampled_blocks"], tr["sample_every"]):
            block_snaps[b] = (before, snapshot(sim.audio.synth), host.copy(), list(sim.voices),
                              sustained_dicts(sim.world.sustained))
        return {"wall": wall, "ok": bool(np.isfinite(host).all()),
                "voices": len(sim.voices), "episode": ep}

    if ctx.trace:
        profile.reset()
    units, window_s, summary = closed_loop(ctx, step, tr["trace_units"])
    peak = memory_peak(dev)
    models, gains, masses = bank_of(sim.audio, ents)
    del sim
    if dev == "cuda":
        torch.cuda.empty_cache()  # the program's cached blocks, before the reference's
    t0 = time.perf_counter()
    refs = reference_solves(cfg)
    print(f"portbench: reference solves: {time.perf_counter() - t0:.1f} s", file=sys.stderr,
          flush=True)
    t0 = time.perf_counter()
    checks, held = reference_checks(cfg, models, gains, masses, refs, step_snaps, block_snaps,
                                    block_impacts, ctx.cell_limits)
    print(f"portbench: reference of steps {len(step_snaps)} and blocks {sorted(block_snaps)}: "
          f"{time.perf_counter() - t0:.1f} s; held {held}", file=sys.stderr, flush=True)
    return Run(units=units, window_s=window_s, setup_s=setup_s, attempted=len(units),
               failed=sum(1 for u in units if not u["ok"]), checks=checks,
               memory_peak_bytes=peak,
               counters={"checked_blocks": sorted(block_snaps),
                         "checked_steps": len(step_snaps), **held},
               trace=summary)


def reference_checks(cfg, models, gains, masses, refs, step_snaps, block_snaps,
                     block_impacts, limits) -> tuple:
    """The checks, and the counts of checked steps with an impact and of held blocks with
    an impact and with voices."""
    import torch

    play = cfg["play"]
    sr, n = float(play["sample_rate"]), int(play["block"])
    scene = bodies(cfg)
    worst = dict.fromkeys(PHYSICS_CHECKS, 0.0)
    for before, after, impacts, sustained in step_snaps:
        got = step_gaps((after, impacts, sustained), reference_step(cfg, scene, before))
        worst = {k: max(worst[k], got[k]) for k in worst}
    aud = audible(cfg, models, [refs[kind][1] for kind in kinds(cfg)])
    strikes = {}

    def strikes_of(e):
        if e not in strikes:
            strikes[e] = ref_scene.strikes(impact_dicts(block_impacts[e]), aud)
        return strikes[e]

    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 8))
    tracks, voice_gap, block_gap, state_gap, chattering = {}, 0.0, 0.0, 0.0, []
    held = {"impact_steps": sum(1 for s in step_snaps if s[2]), "impact_blocks": 0,
            "voiced_blocks": 0}
    for b in sorted(block_snaps):
        before, after, out, program_voices, sustained = block_snaps[b]
        voices = ref_voices(cfg, sustained, aud, sr)
        voice_gap = max(voice_gap, play_loop.voice_checks(program_voices, voices))
        tabs = block_tables(models, gains, sr, voices, play["surface"], tracks)
        got = block_gaps(tabs, before, after, out, live_strikes(b, strikes_of, n, sr), n)
        if got is None:
            chattering.append(b)
            continue
        held["impact_blocks"] += bool(block_impacts[b])
        held["voiced_blocks"] += bool(program_voices)
        block_gap, state_gap = max(block_gap, got[0]), max(state_gap, got[1])
    torch.set_num_threads(threads)
    print(f"portbench: blocks {chattering} chatter, not held to block_rel and state_rel",
          file=sys.stderr, flush=True)
    values = dict(model_gaps(cfg, models, masses, refs), **worst, voice_rel=voice_gap,
                  block_rel=block_gap, state_rel=state_gap,
                  coverage_gaps=sum(1 for v in held.values() if v == 0))
    return [Check(k, v, limits[k]) for k, v in values.items()], held


def small(config, traffic):
    """The CPU tests' cut: coarse surfaces (icosphere_surface(2), grid_box_surface(3)) at
    tet_resolution 6, and 4-block episodes, thrown down at the floor from within a centimetre
    of it (the balls' centres below their radius) so that every episode strikes, slides and
    rolls; half the steps and blocks checked."""
    sc = config["scene"]
    sc["ball"]["surface"]["subdivisions"] = 2
    sc["block"]["surface"]["segments"] = 3
    config["tet_resolution"] = 6
    config["layout"].update(y_m=[0.021, 0.03], vy_mps=[-1.0, -0.6], first_y_m=0.049)
    traffic.update(episode_blocks=4, warm_blocks=4, trace_units=4, sample_every=0.5,
                   step_every=0.5)
    return config, traffic


def _bf16_voices(voices) -> list:
    bf16 = play_loop._bf16
    out = []
    for v in voices:
        w = dict(v)
        for key in ("normal_force", "friction", "stiffness", "static_pen", "damping"):
            w[key] = bf16(v[key])
        for key in ("normal", "slip"):
            w[key] = np.array([bf16(a) for a in v[key]])
        w["sweep"] = tuple(np.array([bf16(a) for a in s]) for s in v["sweep"])
        w["tracks"] = [(t[0], *(bf16(a) for a in t[1:])) for t in v["tracks"]]
        out.append(w)
    return out


def _as_program(voices) -> list:
    from types import SimpleNamespace

    return [SimpleNamespace(
        voice_id=v["voice_id"], obj=v["obj"], blend_points=(v["expos"],) * 3,
        stiffness=v["stiffness"], static_penetration=v["static_pen"],
        damping_coeff=v["damping"], normal_force=v["normal_force"], friction=v["friction"],
        normal=tuple(v["normal"]), slip_dir=tuple(v["slip"]), sweep_dir=v["sweep"],
        tracks=[SimpleNamespace(index=0 if t[0] is not None else -1, rate=t[1], sigma=t[2],
                                window=t[3], step=t[4]) for t in v["tracks"]])
        for v in voices]


def control(config, traffic, seed, limits, blocks):
    """The float32 reference solves, physics reference and the bfloat16 render against the
    float64 ones: the solves' models and mass properties by the model checks; over the
    seed's first episode (at least `blocks` blocks), the float64 reference steps the
    episode, and at every step the float32 one steps from the same state; the bfloat16
    render plays the episode's strikes and voices (rounded to bfloat16) on its own state,
    and the float64 render each block from that state. The bank is the float64 reference
    solves of the scene."""
    import torch

    play, ph = config["play"], config["physics"]
    sr, n = float(play["sample_rate"]), int(play["block"])
    refs, low_refs = reference_solves(config), reference_solves(config, np.float32)
    models = [refs[kind][0] for kind in kinds(config)]
    masses = [refs[kind][1] for kind in kinds(config)]
    gains = [play["modal_level"] / max(len(m["freqs"]), 1) * 1e3 for m in models]
    model_values = model_gaps(config, [low_refs[kind][0] for kind in kinds(config)],
                              [low_refs[kind][1] for kind in kinds(config)], refs)
    scene, aud = bodies(config), audible(config, models, masses)
    thrown = throw(seed, 0, config)  # the floor first, at rest; every body unrotated
    state = ref_physics.State(np.array([np.zeros(3)] + [p for p, _v, _w in thrown]),
                              np.tile([1.0, 0.0, 0.0, 0.0], (len(scene), 1)),
                              np.array([np.zeros(3)] + [v for _p, v, _w in thrown]),
                              np.array([np.zeros(3)] + [w for _p, _v, w in thrown]))
    worst = dict.fromkeys(PHYSICS_CHECKS, 0.0)
    strikes, sustained_at = {}, {}
    carry = 0.0
    for b in range(max(blocks, traffic["episode_blocks"])):
        carry += n / sr / ph["dt"]
        steps = int(carry)
        carry -= steps
        impacts = []
        for _ in range(steps):
            want = reference_step(config, scene, state)
            got = reference_step(config, scene, state, np.float32)
            gaps = step_gaps(got, want)
            worst = {k: max(worst[k], gaps[k]) for k in worst}
            state = want[0]
            impacts += want[1]
        strikes[b] = ref_scene.strikes(impacts, aud)
        sustained_at[b] = want[2]
    tracks = {}
    z = np.zeros((len(models), max(len(m["freqs"]) for m in models)))
    low_state = {"z_re": z, "z_im": z, "carries": {}}
    voice_gap = block_gap = state_gap = 0.0
    for b in sorted(strikes):
        voices = ref_voices(config, sustained_at[b], aud, sr)
        low = _bf16_voices(voices)
        voice_gap = max(voice_gap, play_loop.voice_checks(_as_program(low), voices))
        live = live_strikes(b, strikes.get, n, sr)
        low_tab = tables(models, gains, sr, low, play["surface"], torch.bfloat16, tracks)
        out, z_re, z_im, carries = ref_scene.render_block(
            low_tab, low_state["z_re"], low_state["z_im"], live, low_state["carries"], n)
        after = {"z_re": z_re, "z_im": z_im, "carries": carries}
        tabs = block_tables(models, gains, sr, voices, play["surface"], tracks)
        got = block_gaps(tabs, low_state, after, out, live, n)
        if got is not None:
            block_gap, state_gap = max(block_gap, got[0]), max(state_gap, got[1])
        low_state = after
    return dict(model_values, **worst, voice_rel=voice_gap, block_rel=block_gap,
                state_rel=state_gap)
