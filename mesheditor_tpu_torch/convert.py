"""Build the port's objects from the reference package's state, handed over as numpy arrays
(np.asarray of each JAX field), so that both packages can be fed identical inputs."""

from __future__ import annotations

import numpy as np
import torch

from .fem.assembly import ElementOperators
from .solve.amg import AmgPrecond
from .synth.bank import BankParams, BankState, ImpactTable
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


def modal_modes(*, freqs, t60s, shapes, positions=None,
                original_fundamental_freq=0.0) -> ModalModes:
    """The port's ModalModes from the reference's (freqs, t60s, shapes[, positions])."""
    modes = ModalModes(np.asarray(freqs), np.asarray(t60s), np.asarray(shapes),
                       original_fundamental_freq=float(original_fundamental_freq))
    if positions is not None:
        modes.positions = np.asarray(positions, np.float32).reshape(-1, 3)
    return modes
