"""Build the port's objects from the reference package's state, handed over as numpy arrays
(np.asarray of each JAX field) or as the reference's own host-side dataclasses (rebuilt by
class and field name, `from_reference`), so that both packages can be fed identical inputs.
Nothing of the reference package is imported here: its objects are only read."""

from __future__ import annotations

import dataclasses
import enum
import importlib

import numpy as np
import torch

from .fem.assembly import ElementOperators
from .solve.amg import AmgPrecond
from .synth.bank import BankParams, BankState, ImpactTable, TrackPool, VoiceTable
from .types import ModalModes


def _f64(a, device):
    return torch.tensor(np.asarray(a, np.float64), device=device)


def _f32(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=device)


def element_operators(*, elem_dofs, k_blocks, rho_vol, m_unit, k_fix, m_fix, n_dofs,
                      device="cpu") -> ElementOperators:
    """ElementOperators from the reference's elem_dofs (E, 30), k_blocks, rho_vol, m_unit,
    k_fix, m_fix (float64 throughout)."""
    nodes = np.asarray(elem_dofs, np.int64)[:, ::3] // 3
    return ElementOperators(
        torch.as_tensor(nodes, device=device), _f64(k_blocks, device), _f64(rho_vol, device),
        _f64(m_unit, device), _f64(k_fix, device), _f64(m_fix, device), int(n_dofs),
    )


def amg_precond(*, agg6, w, ac_inv, inv_diag, rigid, m_rigid, mc, omega, nagg, sa=0.0,
                device="cpu") -> AmgPrecond:
    """AmgPrecond from the reference's fields (agg6 (n_nodes, 6) coarse dof ids; the
    float32 arrays are widened to float64)."""
    agg = np.asarray(agg6, np.int64)[:, 0] // 6
    return AmgPrecond(
        torch.as_tensor(agg, device=device), _f64(w, device), _f64(ac_inv, device),
        _f64(inv_diag, device), _f64(rigid, device), _f64(m_rigid, device), _f64(mc, device),
        float(omega), int(nagg), float(sa),
    )


def bank(*, coeff_re, coeff_im, disp_scale, shapes, out_gain, sample_rate, z_re, z_im,
         device="cpu") -> tuple[BankParams, BankState]:
    """(BankParams, BankState) from the reference's bank fields (float32)."""
    params = BankParams(_f32(coeff_re, device), _f32(coeff_im, device),
                        _f32(disp_scale, device), _f32(shapes, device),
                        _f32(out_gain, device), float(sample_rate))
    return params, BankState(_f32(z_re, device), _f32(z_im, device))


def impact_table(device="cpu", **fields) -> ImpactTable:
    """ImpactTable from the reference's nine impact fields."""
    return ImpactTable.from_numpy({f: np.array(fields[f]) for f in ImpactTable.FIELDS},
                                  device)


def voice_table(device="cpu", **fields) -> VoiceTable:
    """VoiceTable from the reference's voice fields (pos_base stays float64)."""
    return VoiceTable.from_numpy({f: np.array(fields[f]) for f in VoiceTable.FIELDS}, device)


def track_pool(heights, sums, device="cpu") -> TrackPool:
    """TrackPool from the reference's (T, N) heights and (T, N + 1) running sums."""
    return TrackPool(_f32(heights, device), _f32(sums, device))


def modal_modes(*, freqs, t60s, shapes, positions=None,
                original_fundamental_freq=0.0) -> ModalModes:
    """The port's ModalModes from the reference's (freqs, t60s, shapes[, positions])."""
    modes = ModalModes(np.asarray(freqs), np.asarray(t60s), np.asarray(shapes),
                       original_fundamental_freq=float(original_fundamental_freq))
    if positions is not None:
        modes.positions = np.asarray(positions, np.float32).reshape(-1, 3)
    return modes


# Modules whose dataclasses and enums have a same-named counterpart in the reference.
_COUNTERPART_MODULES = ("types", "scene.components", "scene.animation", "scene.armature",
                        "solve.postprocess", "solve.mesh2modes", "solve.orchestration")


def _counterpart(name: str) -> type:
    for mod in _COUNTERPART_MODULES:
        cls = getattr(importlib.import_module(f"{__package__}.{mod}"), name, None)
        if isinstance(cls, type):
            return cls
    raise TypeError(f"no counterpart of the reference's {name} in {__package__}")


def from_reference(obj):
    """The port's copy of a host-side reference object: a dataclass (a component, a
    ModalResult, ModalModes, MassProperties, ...) becomes the port's class of the same name
    with every field converted in turn, an enum member the same-named member, an array a
    numpy copy; containers are walked and anything else is returned as it is."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = _counterpart(type(obj).__name__)
        return cls(**{f.name: from_reference(getattr(obj, f.name))
                      for f in dataclasses.fields(cls) if f.init})
    if isinstance(obj, enum.Enum):
        return _counterpart(type(obj).__name__)[obj.name]
    if isinstance(obj, (np.ndarray, np.generic)) or hasattr(obj, "__array__"):
        return np.array(obj)
    if isinstance(obj, dict):
        return {k: from_reference(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(from_reference(v) for v in obj)
    return obj


def registry(entities: dict):
    """The port's Registry from a reference Registry's state, given as
    {entity: [component, ...]}. Entity ids are kept, so reports that list entities compare
    equal across the packages."""
    from .scene.registry import Registry

    reg = Registry()
    for _ in range(max(entities, default=0)):
        e = reg.create()
        if e not in entities:
            reg.destroy(e)
    for e, components in entities.items():
        for comp in components:
            reg.emplace(e, from_reference(comp))
    reg.drain_events()
    return reg
