"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit) and the
operations and bytes that a block's resonator work needs, counted from the workload (the
objects, the modes each object really has, the samples, the live voices and the
strike-samples whose pulse drives a mode), never from a kernel's padded arguments.

The counts follow chip_smoke.py's `coupled_flops_bytes` and `impact_flops_bytes`, re-based
on the workload's shapes. Per sample and mode: the complex update and its excitation add
(7) and the mix (2); per driving strike-sample and mode, 2; per voice and sample, its
deflection read (2 per mode), its three drive rows (6 per mode) and ~24 scalar contact
operations. Bytes: each input read once and each output written once.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3


def block_flops_bytes(w: dict) -> tuple[float, float]:
    o, k, s, v = w["objects"], w["modes"], w["samples"], w["voices"]
    flops = s * o * k * 9 + 2 * k * w["strike_samples"] + s * v * (8 * k + 24)
    words = (6 * o * k + o  # coefficients and state in, state out, out gains
             + v * (4 * k + 6 + 4) + 3 * s * v  # voice rows, constants, carries; relief, slopes
             + w["strikes"] * k + w["strike_samples"]  # strike gain rows, their forces
             + s)  # the mix
    return float(flops), 4.0 * words


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of operations over the float32 peak
    and bytes over the memory bandwidth."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def roofline_percent(summary, kernel_names) -> float | None:
    """The share of their bound that the traced blocks' resonator kernels reached, in %;
    None where the trace holds no such kernel or no workload."""
    works = (summary.extra or {}).get("work") if summary is not None else None
    device_s = summary.seconds_of(*kernel_names) if works else 0.0
    if not works or device_s <= 0:
        return None
    bound = sum(bound_seconds(*block_flops_bytes(w)) for w in works)
    return 100.0 * bound / device_s
