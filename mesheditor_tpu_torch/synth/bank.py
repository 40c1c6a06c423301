"""The modal synthesis bank: struct-of-arrays over a padded (objects, modes) grid
(counterpart of mesheditor_tpu/synth/bank.py; impact path only).

Each mode is a coupled-form (complex one-pole) resonator: z <- z*c + excitation, output
Im(z) (reference: src/audio/ModalAudio.h:82-116). The bank is a dense (O, K) float32 grid;
muted/padding modes carry coefficient 0, which keeps them exactly inert.

Impacts live in a fixed-capacity table; inactive rows are masked. Render dtypes are
float32, and sample ages are integers, so every precomputed force is an exact function of
(table, global sample index) — the block-boundary-invariance property.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..types import ModalModes


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
    device="cpu",
) -> tuple[BankParams, BankState]:
    """Pack a list of modal models into the padded (O, K) bank on `device`. K pads to a
    multiple of `mode_pad`; P to the max sample-point count.

    Identical models are deduplicated by a content fingerprint (scenes instance one solved
    model across many entities): unique models are packed and uploaded once, and the
    per-object bank expands by an index_select along the object axis on the device."""
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
