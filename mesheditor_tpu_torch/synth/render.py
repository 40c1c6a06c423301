"""Block precompute and bookkeeping of the render (counterpart of
mesheditor_tpu/synth/render.py).

Everything with no feedback dependence is hoisted out of the sample recurrence and
vectorized over the block: the half-sine force curves, the acceleration-noise click, the
per-impact gain rows and, for sustained voices, the surface-track reads (positions are
exact float64 functions of an integer sample age), relief, slopes and the drive/read gain
rows. The recurrences themselves are synth/impact.py and synth/coupled.py (CUDA kernels,
each with its plain PyTorch version beside it); on a card the strike part of the precompute
is one kernel too (synth/strikes.py), and the functions here its plain twin. After the
block, impact ages advance, finished pulses retire, voice carries advance and objects that
fell silent are zeroed.

Contractions are broadcast-multiply + reduce, never a matmul: the render is exact float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .bank import BankParams, BankState, ImpactTable, TrackPool, VoiceTable

# An object whose gain-weighted state energy falls below this (with no active excitation)
# is zeroed (reference: SilentEnergy, ModalAudio.cpp:21).
SILENT_ENERGY = 1e-12
# Distance over which the relief's local mean is removed, m — far longer than any wavelength
# the contact filter passes, so a settled contact is exactly silent (ModalAudio.cpp:23-24).
RELIEF_DC_LENGTH = 1e-2


def _sin(phase: torch.Tensor) -> torch.Tensor:
    """sin of a float32 phase, evaluated in float64 and rounded: every element gets the same
    answer wherever it sits in a tensor (a vectorized float32 sin may round a lane in a
    partial vector differently), which block-boundary invariance needs."""
    return torch.sin(phase.to(torch.float64)).to(torch.float32)


def _impact_force_curves(impacts: ImpactTable, num_samples: int):
    """Half-sine pulse forces for the block, (I, S), plus the previous-sample force (for the
    acceleration-noise click, which is the force derivative). Exact in the integer age."""
    s_idx = torch.arange(num_samples, dtype=torch.int32, device=impacts.age.device)
    ages = impacts.age[:, None] + 1 + s_idx[None, :]  # (I, S)
    live = impacts.active[:, None] & (ages <= impacts.total[:, None])
    phase = math.pi * impacts.pulse_step[:, None] * ages.to(torch.float32)
    force = torch.where(live, impacts.gamma[:, None] * _sin(phase), 0.0)
    prev_age = impacts.age
    prev_live = impacts.active & (prev_age >= 1) & (prev_age <= impacts.total)
    prev_phase = math.pi * impacts.pulse_step * prev_age.to(torch.float32)
    prev_force = torch.where(prev_live, impacts.gamma * _sin(prev_phase), 0.0)
    return force, prev_force


def impact_click(impacts: ImpactTable, force: torch.Tensor, prev_force: torch.Tensor,
                 click_gain: float) -> torch.Tensor:
    """Acceleration-noise click (S,): the force derivative times the click amplitude
    (reference: ModalAudio.cpp:786-813), summed over impacts in table order, one rounded
    add per impact, so each sample's sum is the same however the block is cut."""
    dforce = torch.diff(torch.cat([prev_force[:, None], force], dim=1), dim=1)
    amp = impacts.accel_amp * click_gain
    click = torch.zeros(force.shape[1], dtype=torch.float32, device=force.device)
    for i in range(force.shape[0]):
        click = click + amp[i] * dforce[i]
    return click


def impact_gain_rows(params: BankParams, impacts: ImpactTable) -> torch.Tensor:
    """Per-impact gain rows (I, K): the impulse projected onto the struck point's mode
    shapes (reference: ImpactGainRow, ModalAudio.cpp:147-151)."""
    obj = torch.where(impacts.active, impacts.obj, 0).long()
    expos = torch.where(impacts.active, impacts.expos, 0).long()
    shapes = params.shapes[obj, expos]  # (I, K, 3)
    gain = (shapes * impacts.j[:, None, :]).sum(-1)
    return torch.where(impacts.active[:, None], gain, 0.0)


def _read_tracks_block(pool: TrackPool, voices: VoiceTable, num_samples: int):
    """Windowed track heights for every (voice, track, sample), (V, 4, S) float32: the
    contact-filter read (reference: ReadTrack, SurfaceNoise.h:54-65). Positions are float64
    (a float32 position moves the read by whole track samples after a few seconds)."""
    n = pool.heights.shape[1]
    dev = pool.heights.device
    s_idx = torch.arange(num_samples, dtype=torch.int64, device=dev)
    ages = voices.age.to(torch.int64)[:, None, None] + 1 + s_idx[None, None, :]  # (V, 1, S)
    pos = voices.pos_base[:, :, None] + ages.to(torch.float64) * voices.track_rate.to(
        torch.float64)[:, :, None]  # (V, 4, S) f64
    slot = voices.track_idx.clamp_min(0).long()[:, :, None]  # (V, 4, 1)
    has_track = (voices.track_idx >= 0)[:, :, None]

    def wrap(p):
        wraps = torch.floor(p / n)
        f = (p - wraps * n).clamp_min(0.0)
        i = f.to(torch.int64).clamp_max(n - 1)
        return i, (f - i).to(torch.float32), wraps

    def integral(p):
        i, frac, wraps = wrap(p)
        base = pool.sums[slot, i]  # (V, 4, S) gather
        h = pool.heights[slot, i]
        total = pool.sums[slot, n]
        return base + frac * h + wraps.to(torch.float32) * total

    window = voices.track_window[:, :, None]
    half = (0.5 * window).to(torch.float64)
    box = (integral(pos + half) - integral(pos - half)) / window.clamp_min(1e-30)

    i, frac, _ = wrap(pos)
    j = torch.where(i + 1 < n, i + 1, 0)
    h_i = pool.heights[slot, i]
    h_j = pool.heights[slot, j]
    interp = h_i + frac * (h_j - h_i)

    heights = torch.where(window <= 1.0, interp, box)
    heights = torch.where(has_track, heights, 0.0)
    return heights * voices.track_sigma[:, :, None]


def _voice_gain_rows(params: BankParams, voices: VoiceTable, coupling: float):
    """Drive gain rows (mode shapes blended over the contact triangle, projected onto the
    contact directions) and the deflection read-out row, each (V, K) and fixed for the
    block (reference: RenderObjectCoupled prologue, ModalAudio.cpp:388-415). Broadcast
    multiply + reduce, never a matmul: exact float32."""
    # Out-of-range rows and sample points clamp, as the reference's gathers do.
    obj = voices.obj.clamp(0, params.shapes.shape[0] - 1).long()
    pts = voices.blend_pts.clamp(0, params.shapes.shape[1] - 1).long()  # (V, 3)
    sh = params.shapes[obj[:, None], pts]  # (V, 3, K, 3)
    blend = (voices.blend_w[:, :, None, None] * sh).sum(1)  # (V, K, 3)
    gain_n = (blend * voices.normal[:, None, :]).sum(-1)
    gain_geo0 = (blend * voices.sweep[:, 0][:, None, :]).sum(-1)
    gain_geo1 = (blend * voices.sweep[:, 1][:, None, :]).sum(-1)
    gain_fric = (blend * voices.slip[:, None, :]).sum(-1)
    # The separation is modulated by the object's own vibration along the same normal.
    read_gain = coupling * gain_n * params.disp_scale[obj]  # (V, K)
    return gain_n, gain_geo0, gain_geo1, gain_fric, read_gain


@dataclass
class VoiceBlock:
    """The voice precompute of one block (everything the coupled recurrence reads)."""

    heights: torch.Tensor  # (V, 4, S) track heights
    relief: torch.Tensor  # (V, S)
    slope0: torch.Tensor  # (V, S) surface 0's slope sum
    slope1: torch.Tensor  # (V, S)
    alpha: torch.Tensor  # (V,) relief-mean leak per sample
    rm0: torch.Tensor  # (V,) relief-mean carry at the block start (priming applied)
    pen0: torch.Tensor  # (V,) penetration carry at the block start
    gains: tuple  # (gain_n, gain_geo0, gain_geo1, gain_fric, read_gain), each (V, K)


def voice_block(params: BankParams, voices: VoiceTable, pool: TrackPool, num_samples: int,
                coupling: float = 1.0) -> VoiceBlock:
    """Track heights, relief, per-surface slopes, the relief-mean leak, the primed carries
    and the gain rows of one block (reference: render_block_impl's voice precompute)."""
    heights = _read_tracks_block(pool, voices, num_samples)  # (V, 4, S)
    # Sums over the four tracks written out, so every sample rounds the same way.
    relief = heights[:, 0] + heights[:, 1] + heights[:, 2] + heights[:, 3]
    h_prev = torch.cat([voices.prev_height[:, :, None], heights[:, :, :-1]], dim=2)
    step = voices.track_step[:, :, None]
    moving = step > 0
    slope_terms = torch.where(moving, (heights - h_prev) / torch.where(moving, step, 1.0), 0.0)
    # A voice's first-ever sample has no previous height to difference against.
    slope_terms[:, :, 0] = torch.where(~voices.primed[:, None], 0.0, slope_terms[:, :, 0])
    # A track's surface is its index's low bit (reference: ModalAudio.cpp:252-263).
    slope0 = slope_terms[:, 0] + slope_terms[:, 2]
    slope1 = slope_terms[:, 1] + slope_terms[:, 3]
    distance = voices.track_step.max(1).values
    alpha = (distance / RELIEF_DC_LENGTH).clamp_max(1.0)
    rm0 = torch.where(voices.primed, voices.relief_mean, relief[:, 0])
    pen0 = torch.where(voices.primed, voices.penetration, voices.static_pen.clamp_min(0.0))
    return VoiceBlock(heights, relief, slope0, slope1, alpha, rm0, pen0,
                      _voice_gain_rows(params, voices, coupling))


def finish_block(params: BankParams, impacts: ImpactTable, z_re: torch.Tensor,
                 z_im: torch.Tensor, num_samples: int, voices: VoiceTable | None = None,
                 vblock: VoiceBlock | None = None, rm_out=None, pen_out=None, shard=None):
    """Advance impact ages, retire finished pulses, advance the voice carries (when a
    voice table is given with its block precompute and the recurrence's relief-mean and
    penetration carries), and zero objects whose gain-weighted energy fell below
    SILENT_ENERGY with no active excitation, live impact or live voice (reference:
    SilenceObject via RenderObjectFast, ModalAudio.cpp:206-209).

    With `shard` (parallel/sharding.py:ObjectBlock) the bank is this rank's block of
    objects and the tables are the whole replicated ones: ages and retirement read no
    object, so they stay equal on every rank; silence reads this rank's objects only; each
    live voice's carries come from the rank that owns its object.
    Returns (state, impacts, voices)."""
    n_obj = z_re.shape[0]
    new_age = impacts.age + num_samples
    active = impacts.active & (new_age < impacts.total)
    impacts = ImpactTable(
        active=active, obj=impacts.obj, expos=impacts.expos, j=impacts.j,
        pulse_step=impacts.pulse_step, gamma=impacts.gamma, accel_amp=impacts.accel_amp,
        age=new_age, total=impacts.total,
    )
    energy = (z_re * z_re + z_im * z_im).sum(1)
    here = impacts if shard is None else shard.local_impacts(impacts)
    obj = torch.where(here.active, here.obj, 0).long()
    has_excite = torch.zeros(n_obj, dtype=torch.float32, device=z_re.device)
    has_excite.index_add_(0, obj, here.active.to(torch.float32))
    if voices is not None:
        v_here = voices if shard is None else shard.local_voices(voices)
        v_live = v_here.active & (v_here.obj >= 0) & (v_here.obj < n_obj)
        has_excite.index_add_(0, torch.where(v_live, v_here.obj, 0).long(),
                              v_live.to(torch.float32))
        if shard is not None:
            rm_out, pen_out = shard.owned(voices, rm_out), shard.owned(voices, pen_out)
        voices = voices.replace(
            age=voices.age + num_samples,
            prev_height=torch.where(voices.active[:, None], vblock.heights[:, :, -1],
                                    voices.prev_height),
            relief_mean=rm_out,
            penetration=pen_out,
            primed=voices.primed | voices.active,
        )
    silent = (energy * params.out_gain**2 < SILENT_ENERGY) & (has_excite == 0)
    keep = (~silent)[:, None].to(torch.float32)
    return BankState(z_re=z_re * keep, z_im=z_im * keep), impacts, voices


def render_block(params: BankParams, state: BankState, impacts: ImpactTable,
                 voices: VoiceTable, pool: TrackPool, num_samples: int,
                 click_gain: float = 1.0, sustain_level: float = 1.0, coupling: float = 1.0,
                 debug: bool = False, *, n_slots: int | None = None,
                 n_per_obj: int | None = None, shard=None):
    """Advance the whole scene `num_samples` samples (reference: synth/render.py
    `render_block`). Returns (state, impacts, voices, out), `out` the mono mix
    (num_samples,) float32.

    A block with a live voice goes through the coupled render (synth/coupled.py), a
    voice-free block through the impact render (synth/impact.py), which leaves `voices` as
    it was; `ModalSynth.render` comes here for every block. `n_slots` bounds the live
    impacts per object and `n_per_obj` the live voices per object; None counts them from
    the tables (a device sync on a CUDA table). `shard` is as in those renders.

    `debug=True` returns (state, impacts, voices, out, dbg) with the reference's per-sample
    traces: every block, voiced or not, goes through the coupled precompute and the plain
    recurrence (`coupled._resonate_coupled_plain`) on the tables' device, as the
    reference's debug output comes from its scan and not from its kernels. `dbg` holds the
    block precompute, "relief", "slope0", "slope1" (V, S), "heights" (V, 4, S) and "rm0"
    (V,), the carries after the block, "rm_out" and "pen_out" (V,), and one row a sample
    of "rm_t", "pen_t", "force_t" (the Hunt-Crossley force before the normal load is taken
    off) and "relief_t", each (S, V) float32. Rows of voices that are not stepped (inactive
    or out of range) keep their carries in "rm_t"/"pen_t" and a force of 0, where the
    reference steps every row. A voice-free block leaves `voices` as it was, as without
    `debug`. A sharded bank (`shard`) has no debug route."""
    from .coupled import render_block_coupled
    from .impact import render_block_impacts

    if debug and shard is not None:
        raise ValueError("render_block: debug=True traces one process's whole tables; "
                         "it does not take shard")
    n_obj = params.coeff_re.shape[0]
    if n_slots is None:
        obj = impacts.obj[impacts.active].long()
        n_slots = int(torch.bincount(obj, minlength=1).max()) if obj.numel() else 0
    if n_per_obj is None:
        live = voices.active & (voices.obj >= 0) & (voices.obj < n_obj)
        obj = voices.obj[live].long()
        n_per_obj = int(torch.bincount(obj, minlength=1).max()) if obj.numel() else 0
    if debug:
        return _render_block_traced(params, state, impacts, voices, pool, num_samples,
                                    click_gain, sustain_level, coupling, n_slots, n_per_obj)
    if n_per_obj:
        return render_block_coupled(params, state, impacts, voices, pool, num_samples,
                                    click_gain, sustain_level, coupling, n_slots, n_per_obj,
                                    shard)
    state, impacts, out = render_block_impacts(params, state, impacts, num_samples,
                                               click_gain, n_slots, shard)
    return state, impacts, voices, out


def _render_block_traced(params, state, impacts, voices, pool, num_samples, click_gain,
                         sustain_level, coupling, n_slots, n_per_obj):
    """render_block's debug route: coupled_inputs, the plain recurrence with its trace,
    then finish_block. Returns (state, impacts, voices, out, dbg)."""
    from .coupled import _group_voices, _resonate_coupled_plain, coupled_inputs

    args, vb, click = coupled_inputs(params, state, impacts, voices, pool, num_samples,
                                     click_gain, sustain_level, coupling, n_slots, n_per_obj)
    order, offsets = _group_voices(args[12], params.coeff_re.shape[0], args[13])
    mix, z_re, z_im, rm_out, pen_out, rows = _resonate_coupled_plain(
        *args[:13], order, offsets, trace=True)
    if n_per_obj:
        state, impacts, voices = finish_block(params, impacts, z_re, z_im, num_samples,
                                              voices, vb, rm_out, pen_out)
    else:
        state, impacts, _ = finish_block(params, impacts, z_re, z_im, num_samples)
    dbg = {"relief": vb.relief, "slope0": vb.slope0, "slope1": vb.slope1,
           "heights": vb.heights, "rm0": vb.rm0, "rm_out": rm_out, "pen_out": pen_out,
           **rows}
    return state, impacts, voices, mix + click, dbg
