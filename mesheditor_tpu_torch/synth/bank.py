"""The modal synthesis bank: struct-of-arrays over a padded (objects, modes) grid
(counterpart of mesheditor_tpu/synth/bank.py).

Each mode is a coupled-form (complex one-pole) resonator: z <- z*c + excitation, output
Im(z) (reference: src/audio/ModalAudio.h:82-116). The bank is a dense (O, K) float32 grid;
muted/padding modes carry coefficient 0, which keeps them exactly inert.

Impacts and sustained voices live in fixed-capacity tables; inactive rows are masked.
Render dtypes are float32, except track positions (float64) and integer sample ages, so
every precomputed signal is an exact function of (table, global sample index) — the
block-boundary-invariance property.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..types import ModalModes
from .tracks import TRACK_SAMPLES


@dataclass
class BankParams:
    """Per-(object, mode) resonator parameters and shapes. K and P are padded maxima."""

    coeff_re: torch.Tensor  # (O, K) f32; zero mutes the mode
    coeff_im: torch.Tensor  # (O, K)
    disp_scale: torch.Tensor  # (O, K) meters of displacement per unit state: 1/(2*pi*f)
    shapes: torch.Tensor  # (O, P, K, 3) mass-normalized mode shapes per sample point
    out_gain: torch.Tensor  # (O,)
    sample_rate: float


@dataclass
class BankState:
    z_re: torch.Tensor  # (O, K) f32
    z_im: torch.Tensor  # (O, K) f32

    @staticmethod
    def empty(n_obj: int, n_modes: int, device) -> "BankState":
        z = torch.zeros(n_obj, n_modes, dtype=torch.float32, device=device)
        return BankState(z_re=z, z_im=z.clone())


@dataclass
class ImpactTable:
    """In-flight contact pulses. Each generates a half-sine force curve
    force(age) = gamma * sin(pi * pulse_step * age) for integer age in [1, total]."""

    active: torch.Tensor  # (I,) bool
    obj: torch.Tensor  # (I,) i32
    expos: torch.Tensor  # (I,) i32 sample-point index
    j: torch.Tensor  # (I, 3) f32 node-local impulse vector
    pulse_step: torch.Tensor  # (I,) f32 per-sample phase increment
    gamma: torch.Tensor  # (I,) f32 pulse amplitude
    accel_amp: torch.Tensor  # (I,) f32 acceleration-noise click amplitude
    age: torch.Tensor  # (I,) i32 samples already rendered
    total: torch.Tensor  # (I,) i32 pulse length = ceil(1/pulse_step)

    FIELDS = ("active", "obj", "expos", "j", "pulse_step", "gamma", "accel_amp", "age",
              "total")
    DTYPES = {"active": torch.bool, "obj": torch.int32, "expos": torch.int32,
              "age": torch.int32, "total": torch.int32}

    @staticmethod
    def empty(capacity: int, device) -> "ImpactTable":
        def z(name, *shape):
            return torch.zeros(capacity, *shape, device=device,
                               dtype=ImpactTable.DTYPES.get(name, torch.float32))

        return ImpactTable(**{f: z(f, 3) if f == "j" else z(f) for f in ImpactTable.FIELDS})

    @staticmethod
    def from_numpy(host: dict, device) -> "ImpactTable":
        """One upload per field from numpy arrays keyed by field name."""
        return ImpactTable(**{
            f: torch.as_tensor(host[f], dtype=ImpactTable.DTYPES.get(f, torch.float32),
                               device=device)
            for f in ImpactTable.FIELDS
        })

    def to_numpy(self) -> dict:
        return {f: getattr(self, f).cpu().numpy().copy() for f in self.FIELDS}


# A voice's four drive rows: normal, each surface's geometric tangential, frictional
# (reference: VoiceDrives, src/audio/ModalAudio.cpp:303).
VOICE_DRIVES = 4
VOICE_TRACKS = 4  # two surfaces x (finish, relief)


@dataclass
class VoiceTable:
    """Sustained contacts, each driving one object's modes and reading its deflection back.
    State rows (set on publish) + carry rows (advanced by the render)."""

    active: torch.Tensor  # (V,) bool
    obj: torch.Tensor  # (V,) i32
    blend_pts: torch.Tensor  # (V, 3) i32 sample points the contact reads shapes from
    blend_w: torch.Tensor  # (V, 3) f32 barycentric weights
    normal: torch.Tensor  # (V, 3) node-local unit normal, into the object
    slip: torch.Tensor  # (V, 3) node-local unit slip direction (zero when nothing slides)
    sweep: torch.Tensor  # (V, 2, 3) per-surface geometric drive directions
    normal_force: torch.Tensor  # (V,) N, the load the excitation fluctuates about
    friction: torch.Tensor  # (V,)
    stiffness: torch.Tensor  # (V,) N/m^(3/2)
    static_pen: torch.Tensor  # (V,) m
    damping: torch.Tensor  # (V,) Hunt-Crossley c_d, s/m
    track_idx: torch.Tensor  # (V, 4) i32 pool slot, -1 for unused
    track_rate: torch.Tensor  # (V, 4) track samples per output sample
    track_sigma: torch.Tensor  # (V, 4) height scale, m
    track_window: torch.Tensor  # (V, 4) contact-filter width, track samples
    track_step: torch.Tensor  # (V, 4) surface distance per output sample, m
    # Carry (persists across blocks for a live voice id):
    pos_base: torch.Tensor  # (V, 4) f64 track position at age 0
    age: torch.Tensor  # (V,) i32 samples rendered since adoption
    prev_height: torch.Tensor  # (V, 4) f32
    relief_mean: torch.Tensor  # (V,) f32
    penetration: torch.Tensor  # (V,) f32
    primed: torch.Tensor  # (V,) bool

    FIELDS = ("active", "obj", "blend_pts", "blend_w", "normal", "slip", "sweep",
              "normal_force", "friction", "stiffness", "static_pen", "damping", "track_idx",
              "track_rate", "track_sigma", "track_window", "track_step", "pos_base", "age",
              "prev_height", "relief_mean", "penetration", "primed")
    DTYPES = {"active": torch.bool, "obj": torch.int32, "blend_pts": torch.int32,
              "track_idx": torch.int32, "pos_base": torch.float64, "age": torch.int32,
              "primed": torch.bool}
    SHAPES = {"blend_pts": (3,), "blend_w": (3,), "normal": (3,), "slip": (3,),
              "sweep": (2, 3), "track_idx": (4,), "track_rate": (4,), "track_sigma": (4,),
              "track_window": (4,), "track_step": (4,), "pos_base": (4,),
              "prev_height": (4,)}

    @staticmethod
    def empty(capacity: int, device) -> "VoiceTable":
        def z(name):
            shape = (capacity, *VoiceTable.SHAPES.get(name, ()))
            dtype = VoiceTable.DTYPES.get(name, torch.float32)
            if name == "track_idx":
                return torch.full(shape, -1, dtype=dtype, device=device)
            return torch.zeros(shape, dtype=dtype, device=device)

        return VoiceTable(**{f: z(f) for f in VoiceTable.FIELDS})

    @staticmethod
    def from_numpy(host: dict, device) -> "VoiceTable":
        """One upload per field from numpy arrays keyed by field name."""
        return VoiceTable(**{
            f: torch.as_tensor(np.asarray(host[f]),
                               dtype=VoiceTable.DTYPES.get(f, torch.float32), device=device)
            for f in VoiceTable.FIELDS
        })

    def to_numpy(self) -> dict:
        return {f: getattr(self, f).cpu().numpy().copy() for f in self.FIELDS}

    def replace(self, **fields) -> "VoiceTable":
        return VoiceTable(**{f: fields.get(f, getattr(self, f)) for f in self.FIELDS})


@dataclass
class TrackPool:
    """Device-resident surface tracks, one row per pool slot (the reference keeps 64 slots,
    ModalAudio.h:220-225). A voice's track_idx of -1 reads height 0."""

    heights: torch.Tensor  # (T, N) f32, zero-mean unit-RMS
    sums: torch.Tensor  # (T, N + 1) f32 running integrals

    @staticmethod
    def empty(slots: int, samples: int, device) -> "TrackPool":
        return TrackPool(
            heights=torch.zeros(slots, samples, dtype=torch.float32, device=device),
            sums=torch.zeros(slots, samples + 1, dtype=torch.float32, device=device),
        )


# Packed voice-state upload layout (engine -> device, two buffers per dirty block instead
# of one update per field and row):
# f32 (V, 36): blend_w 0:3 | normal 3:6 | slip 6:9 | sweep 9:15 | normal_force 15 |
#   friction 16 | stiffness 17 | static_pen 18 | damping 19 | track_rate 20:24 |
#   track_sigma 24:28 | track_window 28:32 | track_step 32:36
# i32 (V, 10): obj 0 | blend_pts 1:4 | track_idx 4:8 | active 8 | reset 9
VOICE_F32_COLS = 36
VOICE_I32_COLS = 10


def apply_voice_state(voices: VoiceTable, f32buf: torch.Tensor,
                      i32buf: torch.Tensor) -> VoiceTable:
    """Write the published per-voice STATE into the device table and reset the carries of
    freshly opened rows (reset column). Carries of persisting voices are untouched — they
    only ever live on the device."""
    f = f32buf.to(torch.float32)
    i = i32buf.to(torch.int32)
    reset = (i[:, 9] != 0)[:, None]
    n_track = voices.pos_base.shape[1]
    # Fresh tracks of one contact start a quarter-cycle apart (reference: StepVoice
    # priming, ModalAudio.cpp:243-247).
    offsets = torch.arange(n_track, dtype=torch.float64, device=f.device)[None, :] * (
        float(TRACK_SAMPLES) / n_track
    )
    return VoiceTable(
        active=i[:, 8] != 0,
        obj=i[:, 0].contiguous(),
        blend_pts=i[:, 1:4].contiguous(),
        blend_w=f[:, 0:3].contiguous(),
        normal=f[:, 3:6].contiguous(),
        slip=f[:, 6:9].contiguous(),
        sweep=f[:, 9:15].reshape(-1, 2, 3).contiguous(),
        normal_force=f[:, 15].contiguous(),
        friction=f[:, 16].contiguous(),
        stiffness=f[:, 17].contiguous(),
        static_pen=f[:, 18].contiguous(),
        damping=f[:, 19].contiguous(),
        track_idx=i[:, 4:8].contiguous(),
        track_rate=f[:, 20:24].contiguous(),
        track_sigma=f[:, 24:28].contiguous(),
        track_window=f[:, 28:32].contiguous(),
        track_step=f[:, 32:36].contiguous(),
        pos_base=torch.where(reset, offsets, voices.pos_base),
        age=torch.where(reset[:, 0], 0, voices.age),
        prev_height=torch.where(reset, 0.0, voices.prev_height),
        relief_mean=torch.where(reset[:, 0], 0.0, voices.relief_mean),
        penetration=torch.where(reset[:, 0], 0.0, voices.penetration),
        primed=torch.where(reset[:, 0], False, voices.primed),
    )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def tune_coeffs(freqs: np.ndarray, t60s: np.ndarray, sample_rate: float):
    """Resonator coefficients from per-mode frequencies (Hz) and T60s (s). Out-of-range and
    undamped modes are muted (coefficient zero). decay = 0.001^(1/(t60*sr));
    c = decay * exp(i*2*pi*f/sr); displacement scale = 1/(2*pi*f)
    (reference: TuneModalObject, src/audio/ModalAudio.cpp:647-674)."""
    freqs = np.asarray(freqs, dtype=np.float64)
    t60s = np.asarray(t60s, dtype=np.float64)
    ok = (
        np.isfinite(freqs)
        & np.isfinite(t60s)
        & (freqs > 0)
        & (freqs < sample_rate / 2 - 1)
        & (t60s > 0)
    )
    safe_f = np.where(ok, freqs, 1.0)
    safe_t = np.where(ok, t60s, 1.0)
    decay = np.power(1e-3, 1.0 / (safe_t * sample_rate))
    omega = 2 * np.pi * safe_f / sample_rate
    c_re = np.where(ok, decay * np.cos(omega), 0.0).astype(np.float32)
    c_im = np.where(ok, decay * np.sin(omega), 0.0).astype(np.float32)
    disp = np.where(ok, 1.0 / (2 * np.pi * safe_f), 0.0).astype(np.float32)
    return c_re, c_im, disp


def build_bank(
    modes_list: Sequence[ModalModes],
    gains: Sequence[float] | None = None,
    sample_rate: float = 48_000.0,
    mode_pad: int = 8,
    point_pad: int = 1,
    device="cuda",
) -> tuple[BankParams, BankState]:
    """Pack a list of modal models into the padded (O, K) bank on `device`. K pads to a
    multiple of `mode_pad`; P to the max sample-point count.

    Identical models are deduplicated by a content fingerprint (scenes instance one solved
    model across many entities): unique models are packed and uploaded once, and the
    per-object bank expands by an index_select along the object axis on the device."""
    device = resolve_device(device)
    n_obj = len(modes_list)
    max_k = _round_up(max((m.num_modes for m in modes_list), default=1) or 1, mode_pad)
    max_p = _round_up(max((m.shapes.shape[0] for m in modes_list), default=1) or 1, point_pad)

    def _fingerprint(m: ModalModes):
        return (
            m.num_modes,
            m.shapes.shape,
            hash(np.ascontiguousarray(m.freqs).tobytes()),
            hash(np.ascontiguousarray(m.t60s).tobytes()),
            hash(np.ascontiguousarray(m.shapes).tobytes()),
        )

    uniq_ids: dict[tuple, int] = {}
    obj_to_uniq = np.zeros(n_obj, np.int64)
    uniq_models = []
    for o, m in enumerate(modes_list):
        key = _fingerprint(m)
        u = uniq_ids.get(key)
        if u is None:
            u = uniq_ids[key] = len(uniq_models)
            uniq_models.append(m)
        obj_to_uniq[o] = u

    n_uniq = len(uniq_models)
    coeff_re = np.zeros((n_uniq, max_k), np.float32)
    coeff_im = np.zeros((n_uniq, max_k), np.float32)
    disp = np.zeros((n_uniq, max_k), np.float32)
    shapes = np.zeros((n_uniq, max_p, max_k, 3), np.float32)
    for u, m in enumerate(uniq_models):
        k = m.num_modes
        if k:
            cr, ci, ds = tune_coeffs(m.freqs, m.t60s, sample_rate)
            coeff_re[u, :k] = cr
            coeff_im[u, :k] = ci
            disp[u, :k] = ds
            p = m.shapes.shape[0]
            shapes[u, :p, :k, :] = m.shapes

    # Unity mix when no gains are given (api.make_synth passes mass-normalized gains).
    out_gain = np.ones(n_obj, np.float32)
    if gains is not None:
        out_gain[:] = np.asarray(gains, np.float32)

    sel = torch.as_tensor(obj_to_uniq, device=device)

    def up(a):
        return torch.as_tensor(a, device=device).index_select(0, sel)

    params = BankParams(
        coeff_re=up(coeff_re),
        coeff_im=up(coeff_im),
        disp_scale=up(disp),
        shapes=up(shapes),
        out_gain=torch.as_tensor(out_gain, device=device),
        sample_rate=float(sample_rate),
    )
    return params, BankState.empty(n_obj, max_k, device)


def tune_object(params: BankParams, o: int, freqs: np.ndarray, t60s: np.ndarray) -> BankParams:
    """Retune one object's coefficients (a new BankParams; the old tensors are left as
    they are). Out-of-range modes mute."""
    k = min(len(freqs), params.coeff_re.shape[1])
    cr, ci, ds = tune_coeffs(np.asarray(freqs)[:k], np.asarray(t60s)[:k], params.sample_rate)
    pad = params.coeff_re.shape[1] - k
    dev = params.coeff_re.device

    def row_set(t, row):
        t = t.clone()
        t[o] = torch.as_tensor(np.pad(row, (0, pad)), device=dev)
        return t

    return BankParams(
        coeff_re=row_set(params.coeff_re, cr),
        coeff_im=row_set(params.coeff_im, ci),
        disp_scale=row_set(params.disp_scale, ds),
        shapes=params.shapes,
        out_gain=params.out_gain,
        sample_rate=params.sample_rate,
    )
