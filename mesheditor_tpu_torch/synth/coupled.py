"""Coupled (sustained-voice + impact) block render through the hand-written CUDA kernel
(counterpart of mesheditor_tpu/synth/pallas_coupled.py).

`resonate_coupled` advances the (O, K) resonator grid and the voices' contact carries over
a whole call. Per sample, in this order: each voice reads its object's deflection from the
previous sample's Im z, steps the Hunt-Crossley contact force (tanh knee against the load),
the shared resonator update runs with the factored impact excitation, each voice's drive is
added into its object's Re z in voice-table order, and the mix is formed.

On a CUDA tensor it launches csrc/coupled_resonator.cu (and raises if that fails); on a CPU
tensor it runs `_resonate_coupled_plain`, the same recurrence in plain PyTorch. There is no
other route: nothing here falls back from the card to the plain version.

Everything without feedback dependence is precomputed per block (synth/render.py:
voice_block) and baked as in the reference: friction and the sustain level ride in the
gain rows (gains4 = gnf, geo0, geo1, read), so the in-kernel force math is three
multipliers per voice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..profile import scope
from .bank import BankParams, BankState, ImpactTable, TrackPool, VoiceTable
from .impact import _check
from .render import finish_block, voice_block
from .strikes import strike_precompute

LAUNCHES = 0  # kernel launches (CUDA tensors only; the plain version is not counted)

_EXCITE_CHUNK = 256  # samples whose impact excitation the plain version forms in one pass


def _group_voices(v_obj: torch.Tensor, n_obj: int, n_per_obj: int):
    """CSR of the voices to step: voices with v_obj in [0, n_obj), sorted by (object, table
    index); a voice ranked >= n_per_obj within its object is dropped. The plain version's
    grouping; the kernel finds the same set, in the same order, itself.
    Returns (order (V,) int32, kept voices first; offsets (O+1,) int32)."""
    n_voice = v_obj.shape[0]
    dev = v_obj.device
    idx = torch.arange(n_voice, device=dev)
    valid = (v_obj >= 0) & (v_obj < n_obj)
    obj = torch.where(valid, v_obj.long(), n_obj)
    order = torch.argsort(obj * (n_voice + 1) + idx)
    sorted_obj = obj[order]
    is_start = torch.ones(n_voice, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_obj[1:] != sorted_obj[:-1]
    rank = idx - torch.cummax(torch.where(is_start, idx, 0), 0).values
    keep = (sorted_obj < n_obj) & (rank < n_per_obj)
    kept_obj = torch.where(keep, sorted_obj, n_obj)
    # Stable: kept voices keep their (object, table index) order, dropped ones go last.
    order = order[torch.argsort(kept_obj * (n_voice + 1) + idx)]
    counts = torch.bincount(kept_obj, minlength=n_obj + 1)[:n_obj]
    offsets = torch.zeros(n_obj + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    return order.to(torch.int32), offsets.to(torch.int32)


def _resonate_coupled_plain(coeff_re, coeff_im, out_gain, gains4, consts, vx, force_sro,
                            gain_rok, z_re, z_im, rm0, pen0, v_obj, order, offsets,
                            trace: bool = False):
    """The plain PyTorch recurrence, in the kernel's operation order (the drives are added
    after the shared update, one voice after another within an object). Returns
    (mix (S,), z_re, z_im, rm (V,), pen (V,)).

    With `trace` it also records, every sample, each voice's relief-mean and penetration
    carries, its Hunt-Crossley force before the normal load is taken off, and the relief it
    read, and returns them after the rest as {"rm_t", "pen_t", "force_t", "relief_t"},
    each (S, V) on the tables' device (the reference's debug scan outputs). Rows of voices
    not stepped hold rm0/pen0 and a force of 0. The recurrence is the same either way."""
    n_samples = vx.shape[0]
    n_slots = gain_rok.shape[0]
    dev = coeff_re.device
    n_kept = int(offsets[-1])
    vid = order[:n_kept].long()
    vobj = v_obj[vid].long()
    # Voices of one layer sit on distinct objects (the r-th voice of each), so each layer's
    # index_add_ is a plain scatter; layers go in rank order, i.e. table order per object.
    rank = torch.arange(n_kept, device=dev) - offsets[vobj].long()
    layers = [(sel, vobj[sel]) for sel in
              (torch.nonzero(rank == r).flatten() for r in range(int(rank.max()) + 1
                                                                 if n_kept else 0))]
    gnf, geo0, geo1, read = (gains4[r, vid] for r in range(4))
    sp, stiff, damp, nf, alpha, sr = (consts[c, vid] for c in range(6))
    # Where the knee fires nf > 0, so dividing by nf there is the reference's
    # normal / where(knee, nf, 1); elsewhere the quotient is not used.
    nf_pos = nf > 0
    nf_safe = torch.where(nf_pos, nf, 1.0)
    vxs = vx[:, :, vid]
    rm, pen = rm0[vid], pen0[vid]
    g = out_gain[:, None]
    mix = []
    rm_rows, pen_rows, force_rows = [], [], []
    zr, zi = z_re, z_im
    for c0 in range(0, n_samples, _EXCITE_CHUNK):
        f = force_sro[c0 : c0 + _EXCITE_CHUNK]  # (C, R, O)
        excite = torch.zeros(f.shape[0], *coeff_re.shape, dtype=torch.float32, device=dev)
        for r in range(n_slots):  # slot order, one rounded add per slot
            excite = excite + f[:, r, :, None] * gain_rok[r]
        rows = vxs[c0 : c0 + f.shape[0]].unbind(0)
        for t, ex in enumerate(excite.unbind(0)):
            if n_kept:
                defl = (read * zi.index_select(0, vobj)).sum(1)
                relief, slope0, slope1 = rows[t]
                rm = rm + (relief - rm) * alpha
                rigid = sp + (relief - rm)
                sep = (rigid - defl).clamp_min(0.0)
                rate = (sep - pen) * sr
                force = (stiff * sep * torch.sqrt(sep) * (1.0 + damp * rate)).clamp_min(0.0)
                normal = force - nf
                knee = (normal > 0) & nf_pos
                normal = torch.where(knee, nf * torch.tanh(normal / nf_safe), normal)
                load = nf + normal
                pen = sep
                drive = ((normal[:, None] * gnf + (load * slope0)[:, None] * geo0)
                         + (load * slope1)[:, None] * geo1)
                if trace:
                    rm_rows.append(rm)
                    pen_rows.append(pen)
                    force_rows.append(force)
            new_re = zr * coeff_re - zi * coeff_im + ex
            new_im = zr * coeff_im + zi * coeff_re
            for sel, objs in layers:
                new_re.index_add_(0, objs, drive[sel])
            zr, zi = new_re, new_im
            mix.append((g * new_im).sum())
    rm_out, pen_out = rm0.clone(), pen0.clone()
    rm_out[vid] = rm
    pen_out[vid] = pen
    mix = torch.stack(mix) if mix else torch.zeros(0, dtype=torch.float32, device=dev)
    if not trace:
        return mix, zr, zi, rm_out, pen_out
    rows = {"rm_t": rm0.expand(n_samples, -1).clone(),
            "pen_t": pen0.expand(n_samples, -1).clone(),
            "force_t": torch.zeros_like(vx[:, 0])}
    if n_kept and n_samples:
        for name, got in zip(rows, (rm_rows, pen_rows, force_rows)):
            rows[name][:, vid] = torch.stack(got)
    rows["relief_t"] = vx[:, 0].clone()
    return mix, zr, zi, rm_out, pen_out, rows


_PLAN_KEYS = ("path", "threads_per_cta", "modes_per_lane",
              "register_voices", "shared_voices", "global_voices", "register_slots", "run",
              "smem_bytes")


def coupled_plan(n_modes: int, n_slots: int, n_per_obj: int) -> dict:
    """The kernel's launch plan at these shapes: its path ("warp": one warp per object, a
    CTA of 32 threads; "block": one CTA per object, a thread per mode), threads per CTA,
    modes per lane, where each object's voice gain rows live (registers,
    shared memory, global memory), impact gain rows in registers, samples staged per pass
    and dynamic shared memory per CTA. Builds the kernel library; needs nvcc."""
    import ctypes

    from .._build import load_kernels

    out = (ctypes.c_int * len(_PLAN_KEYS))()
    if load_kernels().coupled_resonator_plan(n_modes, n_slots, n_per_obj, out) != 0:
        raise ValueError(f"coupled_resonator: shapes K={n_modes} R={n_slots} "
                         f"voices/object={n_per_obj} do not fit")
    plan = dict(zip(_PLAN_KEYS, out))
    plan["path"] = ("warp", "block")[plan["path"]]
    return plan


def _bind(coeff_re, coeff_im, out_gain, gains4, consts, vx, force_sro, gain_rok, z_re, z_im,
          rm0, pen0, v_obj, n_per_obj: int):
    """Check the arguments of a kernel call, allocate the outputs and bind the C entry to
    them. Returns (launch, (mix, z_re, z_im, rm, pen)): launch() runs the kernel on the
    current stream and raises if the launch fails; it counts nothing. The kernel groups the
    voices itself: nothing here launches on the card."""
    device = coeff_re.device
    n_obj, n_modes = coeff_re.shape
    if n_modes > 1024:  # one thread per mode in a block of at most 1,024
        raise ValueError(f"resonate_coupled: at most 1024 modes per object, got {n_modes}")
    n_voice = gains4.shape[1]
    n_slots = gain_rok.shape[0]
    n_samples = vx.shape[0]
    for name, t, shape in (
        ("coeff_re", coeff_re, (n_obj, n_modes)), ("coeff_im", coeff_im, (n_obj, n_modes)),
        ("out_gain", out_gain, (n_obj,)), ("gains4", gains4, (4, n_voice, n_modes)),
        ("consts", consts, (6, n_voice)), ("vx", vx, (n_samples, 3, n_voice)),
        ("force_sro", force_sro, (n_samples, n_slots, n_obj)),
        ("gain_rok", gain_rok, (n_slots, n_obj, n_modes)),
        ("z_re", z_re, (n_obj, n_modes)), ("z_im", z_im, (n_obj, n_modes)),
        ("rm0", rm0, (n_voice,)), ("pen0", pen0, (n_voice,)),
    ):
        _check(name, t, shape, device)
    if (v_obj.dtype != torch.int32 or v_obj.device != device
            or tuple(v_obj.shape) != (n_voice,) or not v_obj.is_contiguous()):
        raise ValueError(f"v_obj: expected contiguous int32 ({n_voice},) on {device}, got "
                         f"{v_obj.dtype} {tuple(v_obj.shape)} on {v_obj.device}")
    from .._build import load_kernels

    lib = load_kernels()
    f32 = dict(dtype=torch.float32, device=device)
    partials = torch.empty(n_obj, n_samples, **f32)
    mix = torch.empty(n_samples, **f32)
    new_re = torch.empty(n_obj, n_modes, **f32)
    new_im = torch.empty(n_obj, n_modes, **f32)
    rm_out, pen_out = rm0.clone(), pen0.clone()
    stream = torch.cuda.current_stream(device).cuda_stream
    tensors = (coeff_re, coeff_im, out_gain, gains4, consts, vx, force_sro, gain_rok, z_re,
               z_im, rm0, pen0, v_obj, new_re, new_im, rm_out, pen_out, partials, mix)
    ptrs = [t.data_ptr() for t in tensors]
    ints = (n_obj, n_modes, n_voice, n_slots, n_samples, min(n_per_obj, n_voice))

    def launch():
        err = lib.coupled_resonator(*ptrs, *ints, stream)
        if err != 0:
            raise RuntimeError(f"coupled_resonator kernel failed: cudaError {err}")

    launch.tensors = tensors  # the kernel's memory lives as long as the launch
    return launch, (mix, new_re, new_im, rm_out, pen_out)


def resonate_coupled(coeff_re, coeff_im, out_gain, gains4, consts, vx, force_sro, gain_rok,
                     z_re, z_im, rm0, pen0, v_obj, n_per_obj: int):
    """Advance the resonator grid and the voices over vx.shape[0] samples.

    coeff_re, coeff_im, z_re, z_im: (O, K); out_gain: (O,); gains4: (4, V, K) (gnf, geo0,
    geo1, read); consts: (6, V) (static penetration, stiffness, damping, normal force,
    relief-mean leak, sample rate); vx: (S, 3, V) (relief, slope0, slope1); force_sro:
    (S, R, O); gain_rok: (R, O, K); rm0, pen0: (V,); all float32. v_obj: (V,) int32, -1 for
    a voice not to step; at most n_per_obj voices per object step (later ones are dropped).
    Returns (mix (S,), z_re, z_im, rm (V,), pen (V,)); rows of voices not stepped keep
    rm0/pen0."""
    global LAUNCHES
    device = coeff_re.device
    if device.type == "cpu":
        n_obj = coeff_re.shape[0]
        order, offsets = _group_voices(v_obj, n_obj, n_per_obj)
        return _resonate_coupled_plain(coeff_re, coeff_im, out_gain, gains4, consts, vx,
                                       force_sro, gain_rok, z_re, z_im, rm0, pen0, v_obj,
                                       order, offsets)
    if device.type != "cuda":
        raise ValueError(f"resonate_coupled: unsupported device {device}")
    launch, out = _bind(coeff_re, coeff_im, out_gain, gains4, consts, vx, force_sro, gain_rok,
                        z_re, z_im, rm0, pen0, v_obj, n_per_obj)
    launch()
    LAUNCHES += 1
    return out


def coupled_inputs(params: BankParams, state: BankState, impacts: ImpactTable,
                   voices: VoiceTable, pool: TrackPool, num_samples: int,
                   click_gain: float = 1.0, sustain_level: float = 1.0,
                   coupling: float = 1.0, n_slots: int = 4, n_per_obj: int | None = None,
                   shard=None):
    """The block precompute of the coupled render: the arguments of `resonate_coupled`,
    the voice precompute and the impact click. `n_slots` bounds the live impacts per object
    and `n_per_obj` the live voices per object (more are dropped; None counts them from the
    table). With `shard` the bank is this rank's block of objects and the tables the whole
    replicated ones: the kernel's arguments hold this rank's impacts and voices, the click
    all impacts. Returns (args, voice_block, click)."""
    n_obj = params.coeff_re.shape[0]
    gain_rok, force_sro, click = strike_precompute(params, impacts, num_samples, click_gain,
                                                   n_slots, shard)
    if shard is not None:
        voices = shard.local_voices(voices)
    live = voices.active & (voices.obj >= 0) & (voices.obj < n_obj)
    if n_per_obj is None:  # a device sync on a CUDA table
        n_per_obj = int(torch.bincount(voices.obj[live].long(), minlength=1).max())

    vb = voice_block(params, voices, pool, num_samples, coupling)
    gain_n, gain_geo0, gain_geo1, gain_fric, read_gain = vb.gains
    sr = np.float32(params.sample_rate)
    # Bake friction and the sustain level into the rows:
    # drive = normal*gnf + (load*slope0)*geo0 + (load*slope1)*geo1.
    scale = (float(np.float32(sustain_level) / sr) * voices.active.to(torch.float32))[:, None]
    gnf = scale * (gain_n + voices.friction[:, None] * gain_fric)
    gains4 = torch.stack([gnf, scale * gain_geo0, scale * gain_geo1, read_gain]).contiguous()
    consts = torch.stack([voices.static_pen, voices.stiffness, voices.damping,
                          voices.normal_force, vb.alpha,
                          torch.full_like(vb.alpha, float(sr))]).contiguous()
    vx = torch.stack([vb.relief, vb.slope0, vb.slope1], 1).permute(2, 1, 0).contiguous()
    v_obj = torch.where(live, voices.obj, -1).to(torch.int32)
    args = (params.coeff_re, params.coeff_im, params.out_gain, gains4, consts, vx, force_sro,
            gain_rok, state.z_re, state.z_im, vb.rm0.contiguous(), vb.pen0.contiguous(), v_obj,
            n_per_obj)
    return args, vb, click


def render_block_coupled(params: BankParams, state: BankState, impacts: ImpactTable,
                         voices: VoiceTable, pool: TrackPool, num_samples: int,
                         click_gain: float = 1.0, sustain_level: float = 1.0,
                         coupling: float = 1.0, n_slots: int = 4,
                         n_per_obj: int | None = None, shard=None):
    """Coupled block render (arguments as `coupled_inputs`). With `shard` the mix is summed
    over the group before the click is added, and each voice's carries come from the rank
    that owns its object. Returns (state, impacts, voices, out (num_samples,) float32)."""
    with scope("play/precompute"):
        args, vb, click = coupled_inputs(params, state, impacts, voices, pool, num_samples,
                                         click_gain, sustain_level, coupling, n_slots,
                                         n_per_obj, shard)
    with scope("play/resonate"):
        mix, z_re, z_im, rm_out, pen_out = resonate_coupled(*args)
        if shard is not None:
            mix = shard.sum(mix)
    with scope("play/finish"):
        state, impacts, voices = finish_block(params, impacts, z_re, z_im, num_samples,
                                              voices, vb, rm_out, pen_out, shard)
    return state, impacts, voices, mix + click
