"""The program's spans and counters (mesheditor_tpu_torch/profile.py) inside the solve and
the block render: off, they leave nothing and cost no record; under a torch.profiler they
record the catalog's names under their parents, one unit span per call, without a wait and
without changing a bit of the answers; the benchmark's trace summary counts none of them as
a device operation, and each metric reader of portbench/metrics finds its span.
"""

import json
import math
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity
from torch.profiler import profile as torch_profile

from mesheditor_tpu_torch import SolverConfig, mesh2modes, profile
from mesheditor_tpu_torch.materials import CERAMIC
from mesheditor_tpu_torch.mesh import box_tets
from mesheditor_tpu_torch.synth import ContactTrackSpec, ModalSynth, SustainedVoice
from mesheditor_tpu_torch.synth.tracks import synthesize_roughness
from mesheditor_tpu_torch.types import ModalModes
from portbench import harness
from portbench.trace import WINDOW_SPAN, summarize

# The catalog: each span's parent (None at the top).
SOLVE_SPANS = {
    "solve/mesh2modes": None,
    "solve/assemble": "solve/mesh2modes",
    "solve/amg": "solve/mesh2modes",
    "solve/eigs": "solve/mesh2modes",
    "solve/eigs/iter": "solve/eigs",
    "solve/eigs/precond": "solve/eigs/iter",
    "solve/eigs/amg": "solve/eigs/precond",
    "solve/eigs/basis": "solve/eigs/iter",
    "solve/eigs/read": "solve/eigs/iter",
}
PLAY_SPANS = {
    "play/block": None,
    "play/events": "play/block",
    "play/voices": "play/block",
    "play/precompute": "play/block",
    "play/resonate": "play/block",
    "play/finish": "play/block",
}
HARNESS_SPANS = {"solve/call", "play/strikes", "play/publish", "play/render", "play/copy"}
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
# The metrics that read the spans and the counter, with the cells each names.
READERS = {m["name"]: m["workloads"] for m in BENCH["per_layer"] if m["name"] in (
    "solve.precond_s", "solve.amg_apply_s", "solve.basis_s", "solve.read_s", "play.events_ms",
    "play.voices_ms", "play.precompute_ms", "play.resonate_ms", "play.finish_ms",
    "play.reads")}


@pytest.fixture(autouse=True)
def _clean_profile():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    profile.enabled = False
    profile.reset()
    yield
    profile.enabled = False
    profile.reset()
    torch.set_num_threads(prev)


def _profiled():
    return torch_profile(activities=[ProfilerActivity.CPU])


def _synth(voiced: bool):
    rng = np.random.default_rng(8)
    freqs, t60s = np.linspace(150, 6000, 16), np.linspace(0.8, 0.1, 16)
    shapes = (rng.standard_normal((3, 16, 3)) * 0.02).astype(np.float32)
    synth = ModalSynth([ModalModes(freqs, t60s, shapes)] * 3, max_impacts=8, max_voices=2,
                       device="cpu")
    slot = synth.adopt_track(5, lambda: synthesize_roughness(2e-4, -2.0, 1e-6))
    voices = []
    if voiced:
        voices = [SustainedVoice(
            voice_id=1, obj=1, blend_points=(0, 1, 0), blend_weights=(0.5, 0.5, 0.0),
            normal=(0.0, 1.0, 0.0), slip_dir=(1.0, 0.0, 0.0),
            sweep_dir=((1.0, 0.0, 0.0), (0.0, 0.0, -1.0)), normal_force=4.0, friction=0.4,
            stiffness=2.0**28, static_penetration=2.0**-20, damping_coeff=0.3,
            tracks=tuple(ContactTrackSpec(index=slot, rate=0.4 + 0.1 * t, sigma=2e-7,
                                          window=6.0, step=4e-7) for t in range(3)))]
    return synth, voices


def _play(synth, voices, blocks: int = 3):
    """Strikes before block 0 only; voices published before every block. Returns the
    samples, the bank state and the voice carries after each block, and the `play/reads`
    count each block added."""
    out, reads = [], []
    synth.strike(0, 1, (0.3, 0.1, 0.05), 0.002, accel_amp=0.001)
    synth.strike(2, 2, (0.1, 0.2, 0.05), 0.001)
    for _ in range(blocks):
        if voices:
            synth.publish_voices(voices)
        before = profile.counts().get("play/reads", 0)
        samples = synth.render(512)
        reads.append(profile.counts().get("play/reads", 0) - before)
        out.append((samples.clone(), synth.state.z_re.clone(), synth.state.z_im.clone(),
                    synth.voices.relief_mean.clone(), synth.voices.penetration.clone()))
    return out, reads


def _small_solve():
    mesh = box_tets((0.3, 0.16, 0.15), (4, 3, 2))
    cfg = SolverConfig(num_modes=20, num_fem_modes=20, small_n=0)  # the device engine
    return mesh2modes(mesh, CERAMIC.properties, mesh.points[::20][:5], config=cfg,
                      device="cpu")


def _parents(records) -> dict:
    out = {}
    for s in records:
        out.setdefault(s.name, set()).add(None if s.parent is None else s.parent.name)
    return out


def _check_catalog(records, catalog):
    assert all(s.name.split("/")[0] in ("solve", "play") for s in records)
    assert not {s.name for s in records} & HARNESS_SPANS
    assert _parents(records) == {name: {parent} for name, parent in catalog.items()}


def test_spans_off_leave_no_record_and_no_count():
    synth, voices = _synth(voiced=True)
    _play(synth, voices, blocks=2)
    _small_solve()
    assert profile.records() == [] and profile.counts() == {} and profile.totals() == {}
    assert profile.self_times() == {} and profile.dropped() == 0


@pytest.mark.parametrize("voiced", [False, True])
def test_play_spans_under_the_profiler_change_no_bit(voiced):
    synth, voices = _synth(voiced)
    plain, plain_reads = _play(synth, voices)
    assert plain_reads == [0, 0, 0]
    synth, voices = _synth(voiced)
    with _profiled() as prof:
        traced, reads = _play(synth, voices)
    for a, b in zip(plain, traced):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    # Nine reads (one a field of the impact table) on the block with pending strikes only.
    assert reads == [9, 0, 0]
    catalog = {k: v for k, v in PLAY_SPANS.items() if voiced or k != "play/voices"}
    records = profile.records()
    _check_catalog(records, catalog)
    names = [s.name for s in records]
    assert names.count("play/block") == 3 and names.count("play/events") == 1
    assert names.count("play/voices") == (3 if voiced else 0)
    assert set(profile.counts()) == {"play/reads"}
    # Each span is a record_function range on the profiler's clock.
    ranges = {e.name for e in prof.events()}
    assert set(catalog) <= ranges


def test_solve_spans_under_the_profiler_change_no_bit():
    plain = _small_solve()
    assert profile.records() == []
    with _profiled() as prof:
        traced = _small_solve()
    assert np.array_equal(plain.modes.freqs, traced.modes.freqs)
    assert np.array_equal(plain.modes.shapes, traced.modes.shapes)
    assert np.array_equal(plain.summary.eigenvalues, traced.summary.eigenvalues)
    records = profile.records()
    _check_catalog(records, SOLVE_SPANS)
    names = [s.name for s in records]
    assert names.count("solve/mesh2modes") == 1
    assert names.count("solve/eigs/iter") == traced.profile.restarts > 0
    (eigs,) = [s for s in records if s.name == "solve/eigs"]
    wall = eigs.end - eigs.start
    assert abs(wall - traced.profile.iterate) <= max(0.01 * traced.profile.iterate, 1e-3)
    assert set(SOLVE_SPANS) <= {e.name for e in prof.events()}
    # Self times add up to the unit span's wall.
    total = sum(t for _n, t in profile.self_times().values())
    (solve,) = [s for s in records if s.name == "solve/mesh2modes"]
    assert total == pytest.approx(solve.end - solve.start, rel=1e-9)


def test_enabled_scopes_fill_the_tree_with_the_stage_spans():
    profile.enabled = True
    res = _small_solve()
    totals = profile.totals()
    top = "solve/mesh2modes"
    eigs = f"{top}/solve/eigs"
    it = f"{eigs}/solve/eigs/iter"
    assert set(totals) == {top, f"{top}/solve/assemble", f"{top}/solve/amg", eigs, it,
                           f"{it}/solve/eigs/precond", f"{it}/solve/eigs/precond/solve/eigs/amg",
                           f"{it}/solve/eigs/basis", f"{it}/solve/eigs/read"}
    assert totals[it][0] == res.profile.restarts
    assert totals[f"{it}/solve/eigs/basis"][0] == 2 * res.profile.restarts


def test_self_times_on_a_hand_built_nest():
    span = profile.Span
    a = span("a", None, 0.0, 10.0)
    b = span("b", a, 1.0, 4.0)
    c = span("b", a, 3.0, 6.0)  # overlaps its sibling: the union counts 1-6 once
    d = span("d", b, 2.0, 3.0)
    e = span("e", None, 20.0, 21.5)
    got = profile.self_times([d, b, c, a, e])
    assert got["a"] == (1, pytest.approx(5.0))
    assert got["b"] == (2, pytest.approx(2.0 + 3.0))
    assert got["d"] == (1, pytest.approx(1.0))
    assert got["e"] == (1, pytest.approx(1.5))


def test_the_buffer_keeps_the_newest_spans_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(profile, "_records", profile.deque(maxlen=4))
    profile.enabled = True
    for i in range(6):
        with profile.scope(f"play/s{i}"):
            pass
    assert [s.name for s in profile.records()] == [f"play/s{i}" for i in range(2, 6)]
    assert profile.dropped() == 2
    profile.reset()
    assert profile.records() == [] and profile.dropped() == 0


def test_a_scope_waits_only_when_enabled(monkeypatch):
    waits = []
    monkeypatch.setattr(profile, "synchronize", lambda dev: waits.append(dev))
    with _profiled():
        with profile.scope("solve/x", sync="cpu"):
            pass
    assert waits == []
    profile.enabled = True
    with profile.scope("solve/x", sync="cpu"):
        pass
    assert waits == [torch.device("cpu")]


def test_the_off_scope_is_one_shared_context():
    assert profile.scope("solve/a") is profile.scope("play/b", sync="cpu")
    profile.count("play/reads", 9)
    assert profile.counts() == {}


def _event(name, device_type, a, b):
    return types.SimpleNamespace(name=name, device_type=device_type,
                                 time_range=types.SimpleNamespace(start=a, end=b))


def test_the_trace_summary_counts_no_program_span_as_an_operation():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [_event(WINDOW_SPAN, cpu, 0, 100), _event("play/render", cpu, 0, 100),
              _event("play/block", cpu, 5, 95), _event("play/precompute", cpu, 10, 40),
              _event("kernel_a", cuda, 30, 35), _event("kernel_b", cuda, 60, 70)]
    # Each span's range as the profiler lays it on the device's timeline too.
    events += [_event(n, cuda, 10, 90) for n in [*SOLVE_SPANS, *PLAY_SPANS]]
    got = summarize(events, 1e-4)
    assert set(got.ops) == {"kernel_a", "kernel_b"} and got.op_count == 2
    assert got.busy_s == pytest.approx(15e-6)
    # Gaps 0-30, 35-60 and 70-100 us, each named by the innermost span open at its
    # midpoint: the program's, not the harness's play/render around them.
    assert got.idle_by_span == {"play/precompute": pytest.approx(30e-6),
                                "play/block": pytest.approx(55e-6)}


def test_only_solve_and_play_scopes_open_a_profiler_range():
    names = ["solve/x", "play/y", "render/rasterize", "mesh2modes"]
    with _profiled() as prof:
        for name in names:
            with profile.scope(name):
                pass
    assert [s.name for s in profile.records()] == names
    ranges = {e.name for e in prof.events()}
    assert [n in ranges for n in names] == [profile.ranged(n) for n in names]
    assert [profile.ranged(n) for n in names] == [True, True, False, False]


def test_the_trace_summary_drops_just_the_ranged_names():
    names = ["solve/x", "play/y", "render/rasterize", "mesh2modes", "kernel_a"]
    got = summarize([_event(n, DeviceType.CUDA, 0, 1) for n in names], 1e-6)
    assert [n in got.ops for n in names] == [not profile.ranged(n) for n in names]


def test_each_table_read_counts_one_play_read_a_field():
    synth, _voices = _synth(voiced=True)
    profile.enabled = True
    synth.impacts.to_numpy()
    assert profile.counts() == {"play/reads": len(synth.impacts.FIELDS)}
    synth.voices.to_numpy()
    assert profile.counts() == {"play/reads": len(synth.impacts.FIELDS)
                                + len(synth.voices.FIELDS)}


@pytest.mark.parametrize("cell", ["box.solve", "box.impacts"])
def test_the_readers_read_nothing_from_a_program_without_spans(cell, monkeypatch):
    import mesheditor_tpu_torch
    from portbench.tests.small import run_small

    run = run_small(cell, trace=True)
    monkeypatch.setattr(mesheditor_tpu_torch, "profile", types.SimpleNamespace(enabled=False))
    for name in READERS:
        assert harness.load_module("metrics", name).read(run) is None, name


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_reader_finds_its_span_in_its_cells(cell):
    from portbench.tests.small import run_small

    run = run_small(cell, trace=True)
    for name, cells in READERS.items():
        value = harness.load_module("metrics", name).read(run)
        if cell in cells:
            assert value is not None and math.isfinite(value) and value >= 0, (name, value)
        elif name == "play.voices_ms":
            assert value is None
    if cell == "box.solve":  # the device engine at the tests' size: every phase ran
        for name in ("solve.precond_s", "solve.amg_apply_s", "solve.basis_s", "solve.read_s"):
            assert harness.load_module("metrics", name).read(run) > 0, name
    if cell in ("box.sustained", "box.impacts"):
        assert harness.load_module("metrics", "play.reads").read(run) > 0
