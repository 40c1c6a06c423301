"""The numbers that decide `correct`, each held to a limit from the cell's file.

Solves: the mode count (exact), the largest relative gap of the frequencies and of the
T60s, and the excitation gains compared in a form that a rotation inside a cluster of
near-equal frequencies leaves alone (per cluster, the sum over its modes of each gain
squared, at every excitation point and axis), and the dofs of the mesh (exact).
Blocks: the largest gap of the samples over the block's peak, of the resonator state after
the block over its largest magnitude, and of the voices' carries; and the voice constants
the bridge derived in set-up.
"""

from __future__ import annotations

import numpy as np

from ..harness import Check

CLUSTER_REL = 1e-3  # modes closer than this (relative) rotate into one another


def answered(modes: dict) -> bool:
    f = modes["freqs"]
    return len(f) > 0 and bool(np.isfinite(f).all())


def _common(modes: dict, ref: dict) -> int:
    """The modes both answers hold, lowest first (the count is compared on its own)."""
    return min(len(modes["freqs"]), len(ref["freqs"]))


def freq_rel(modes: dict, ref: dict) -> float:
    n = _common(modes, ref)
    if n == 0:
        return float("inf")
    a, b = modes["freqs"][:n], ref["freqs"][:n]
    return float((np.abs(a - b) / b).max())


def clusters(freqs) -> list:
    """Runs of consecutive frequencies each within CLUSTER_REL of the previous one."""
    out, start = [], 0
    for k in range(1, len(freqs) + 1):
        if k == len(freqs) or freqs[k] > freqs[k - 1] * (1 + CLUSTER_REL):
            out.append(slice(start, k))
            start = k
    return out


def gain_rel(a_shapes, b_shapes, freqs) -> float:
    """Per cluster of the reference's frequencies, the sum over its modes of the squared
    gains at each (point, axis): the largest gap over the cluster's largest sum."""
    worst = 0.0
    for c in clusters(freqs):
        sa = (a_shapes[:, c, :] ** 2).sum(1)
        sb = (b_shapes[:, c, :] ** 2).sum(1)
        worst = max(worst, float(np.abs(sa - sb).max() / max(sb.max(), 1e-300)))
    return worst


def modes_checks(unit: dict, ref: dict, limits: dict) -> list:
    """The mode count and the dofs (exact), then the frequencies, T60s and gains of the
    modes both answers hold."""
    modes, n = unit["modes"], _common(unit["modes"], ref)
    inf = float("inf")
    checks = [Check("modes", abs(len(modes["freqs"]) - len(ref["freqs"])), 0),
              Check("dofs", abs(int(unit["dofs"]) - int(ref["dofs"])), 0),
              Check("freq_rel", freq_rel(modes, ref), limits["freq_rel"])]
    t60 = float((np.abs(modes["t60s"][:n] - ref["t60s"][:n]) / ref["t60s"][:n]).max()) \
        if n else inf
    checks.append(Check("t60_rel", t60, limits["t60_rel"]))
    gain = gain_rel(modes["shapes"][:, :n], ref["shapes"][:, :n], ref["freqs"][:n]) \
        if n else inf
    checks.append(Check("gain_rel", gain, limits["gain_rel"]))
    return checks


def rel_gap(a, b, floor: float = 0.0) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    if not np.isfinite(a).all():
        return float("inf")
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor, 1e-300))
