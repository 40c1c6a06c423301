"""Block precompute and bookkeeping of the impact render (counterpart of the impact branch
of mesheditor_tpu/synth/render.py).

Everything with no feedback dependence is hoisted out of the sample recurrence and
vectorized over the block: the half-sine force curves, the acceleration-noise click and
the per-impact gain rows. The recurrence itself is synth/impact.py (a CUDA kernel, with its
plain PyTorch version beside it). After the block, impact ages advance, finished pulses
retire and objects that fell silent are zeroed.

Contractions are broadcast-multiply + reduce, never a matmul: the render is exact float32.
"""

from __future__ import annotations

import math

import torch

from .bank import BankParams, BankState, ImpactTable

# An object whose gain-weighted state energy falls below this (with no active excitation)
# is zeroed (reference: SilentEnergy, ModalAudio.cpp:21).
SILENT_ENERGY = 1e-12


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


def finish_block(params: BankParams, impacts: ImpactTable, z_re: torch.Tensor,
                 z_im: torch.Tensor, num_samples: int):
    """Advance impact ages, retire finished pulses, and zero objects whose gain-weighted
    energy fell below SILENT_ENERGY with no active excitation (reference: SilenceObject
    via RenderObjectFast, ModalAudio.cpp:206-209). Returns (state, impacts)."""
    n_obj = z_re.shape[0]
    new_age = impacts.age + num_samples
    active = impacts.active & (new_age < impacts.total)
    impacts = ImpactTable(
        active=active, obj=impacts.obj, expos=impacts.expos, j=impacts.j,
        pulse_step=impacts.pulse_step, gamma=impacts.gamma, accel_amp=impacts.accel_amp,
        age=new_age, total=impacts.total,
    )
    energy = (z_re * z_re + z_im * z_im).sum(1)
    obj = torch.where(active, impacts.obj, 0).long()
    has_excite = torch.zeros(n_obj, dtype=torch.float32, device=z_re.device)
    has_excite.index_add_(0, obj, active.to(torch.float32))
    silent = (energy * params.out_gain**2 < SILENT_ENERGY) & (has_excite == 0)
    keep = (~silent)[:, None].to(torch.float32)
    return BankState(z_re=z_re * keep, z_im=z_im * keep), impacts
