"""Generalized eigensolver entry for the FEM pencil (K, M) (counterpart of
mesheditor_tpu/solve/lobpcg.py).

Two ways to an answer, chosen as the reference chooses them:

- the DEVICE path: the float64 LOBPCG engine (solve/eigs.py) with the AMG preconditioner,
  for pencils above `small_n` dofs;
- the HOST path: scipy's sparse shift-invert Lanczos (eigsh with sigma) on the assembled
  CSR pencil, for pencils at or below `small_n`, and as the fallback when the device path
  has no preconditioner or does not converge and the pencil is host-feasible
  (n <= host_fallback_n).

Which path answered is never silent: DEVICE_SOLVES and HOST_SOLVES count the solves each
path answered in this process.

On an element-sharded pencil (`ops.tp` set) every rank of the group runs the same calls.
The host path then solves the gathered whole pencil and every rank takes the answer of the
group's first rank; the device path takes its eigenvalue estimates, and with them every
host decision (settled count, locking, convergence, NaN), from that rank too, and agrees on
cancellation (eigs.py). So no rank can leave a collective that another still waits in.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

DEVICE_SOLVES = 0  # solves the float64 device engine answered
HOST_SOLVES = 0  # solves the host shift-invert answered (small pencils and fallbacks)


@dataclass
class LobpcgResult:
    eigenvalues: np.ndarray  # (nev,), ascending; empty when the solve failed or was cancelled
    eigenvectors: torch.Tensor  # (n, nev) float64, M-orthonormal, on the pencil's device
    iterations: int = 0
    op_applications: int = 0  # pencil panels applied
    residual_norms: Optional[np.ndarray] = None


def _empty(n: int, device, iterations: int = 0, ops_count: int = 0) -> LobpcgResult:
    return LobpcgResult(np.zeros(0), torch.zeros(n, 0, dtype=torch.float64, device=device),
                        iterations, ops_count)


def _pencil_csr(ops):
    """Scipy CSC (K, M) assembled from the element blocks, float64 on the host (COO
    duplicate summation does the scatter-add)."""
    import scipy.sparse as sp

    ed = ops.elem_dofs.cpu().numpy()  # (E, 30)
    rows = np.repeat(ed, 30, axis=1).reshape(-1)
    cols = np.tile(ed, (1, 30)).reshape(-1)
    n = ops.n_dofs
    kb = ops.k_blocks.cpu().numpy().reshape(-1)
    k = sp.coo_matrix((kb, (rows, cols)), shape=(n, n)).tocsr()
    m_unit = ops.m_unit.cpu().numpy()
    mb = (ops.rho_vol.cpu().numpy()[:, None, None] * m_unit[None]).reshape(-1)
    m = sp.coo_matrix((mb, (rows, cols)), shape=(n, n)).tocsr()
    diag = np.arange(n)
    k = k + sp.coo_matrix((ops.k_fix.cpu().numpy(), (diag, diag)), shape=(n, n))
    m = m + sp.coo_matrix((ops.m_fix.cpu().numpy(), (diag, diag)), shape=(n, n))
    return k.tocsc(), m.tocsc()


def _small_pencil_path(ops, nev: int, p: int, sigma: float, callback) -> LobpcgResult:
    """Host sparse shift-invert (the reference's Spectra + Cholesky role,
    src/audio/mesh2modes.cpp:339-428): factorize K - sigma*M once, Lanczos in the
    shift-inverted spectrum."""
    global HOST_SOLVES
    import scipy.sparse.linalg as spla

    n = ops.n_dofs
    k, m = _pencil_csr(ops.whole())
    p = min(p, n - 1)
    try:
        vals, vecs = spla.eigsh(k, k=p, M=m, sigma=sigma, which="LM")
    except (RuntimeError, ValueError, spla.ArpackError):
        vals, vecs = np.zeros(0), np.zeros((n, 0))
    order = np.argsort(vals)
    vals = vals[order][:nev]
    vecs = torch.as_tensor(vecs[:, order][:, :nev], device=ops.device)
    if ops.tp is not None:  # ARPACK's start differs between processes: take the first rank's
        vals = ops.tp.agree(torch.as_tensor(vals, device=ops.device)).cpu().numpy()
        vecs = ops.tp.agree(vecs)
    if vals.size == 0:
        return _empty(n, ops.device, 0, 1)
    if _cancelled(ops, callback, 1, nev):
        return _empty(n, ops.device, 1, 1)
    HOST_SOLVES += 1
    return LobpcgResult(vals.copy(), vecs, 1, 1, residual_norms=np.zeros(nev))


def _cancelled(ops, callback, iteration: int, settled: int) -> bool:
    """callback(iteration, settled) asks for cancellation; on a sharded pencil the group
    cancels when any rank asks."""
    ask = callback is not None and bool(callback(iteration, settled))
    return ask if ops.tp is None else ops.tp.any(ask)


def _settled_prefix(lam, prev, nev, tol, sigma, floor_rel, cluster_rel=1e-4):
    """Leading prefix of pairs whose eigenvalue settled, mirroring the reference's
    SubspaceIterate criterion (mesh2modes.cpp:403-410): relative change under tol, with
    an absolute floor scaled to the wanted window for near-zero (rigid-body) values.

    CLUSTER-AWARE: adjacent eigenvalues whose relative gap is below cluster_rel are a
    near-degenerate group (symmetric geometry — a torus carries its spectrum almost
    entirely in pairs). Rayleigh-Ritz keeps rotating inside such a group, so the
    individual values exchange by ~cluster width every iteration and NEVER settle
    per-index; the group's MEAN is rotation-invariant and converges. Physics is
    indifferent to intra-cluster assignment: the width bound keeps every member within
    cluster_rel/2 in frequency, far inside the 0.1% parity gate."""
    delta = np.abs(lam[:nev] - prev[:nev])
    denom = np.maximum(np.abs(lam[:nev]), abs(sigma))
    rel = delta / denom
    window = max(float(np.abs(lam[:nev]).max()), abs(sigma))
    ok = (rel < tol) | (delta < floor_rel * window)
    if not ok.all():
        # Cluster pass: means over maximal runs of near-equal values.
        gaps = np.abs(np.diff(lam[:nev]))
        gap_rel = gaps / np.maximum(denom[1:], 1e-300)
        same = gap_rel < cluster_rel
        start = 0
        for i in range(nev):
            last = i + 1 >= nev or not same[i]
            if last:
                if start < i or not ok[start]:  # singleton clusters keep per-index ok
                    m_now = lam[start : i + 1].mean()
                    m_prev = prev[start : i + 1].mean()
                    d = abs(m_now - m_prev)
                    c_ok = (d / max(abs(m_now), abs(sigma)) < tol) or (d < floor_rel * window)
                    if start < i and c_ok:
                        ok[start : i + 1] = True
                start = i + 1
    settled = 0
    for v in ok:
        if v:
            settled += 1
        else:
            break
    return settled, rel, delta, window


def lobpcg_pencil(
    ops,
    nev: int,
    *,
    sigma: float,
    precond=None,
    x0: Optional[np.ndarray] = None,
    guard: int = 15,
    tol: float = 1e-8,
    max_iters: int = 100,
    inner_iters: int = 10,
    seed: int = 20260710,
    callback: Optional[Callable[[int, int], bool]] = None,
    small_n: int = 9000,
    host_fallback_n: int = 120_000,
) -> LobpcgResult:
    """Lowest `nev` eigenpairs of K x = lambda M x for element-form operators `ops`.

    `sigma` (negative) shifts the preconditioner pencil. `x0` (n, >=1) seeds the leading
    elastic columns (warm start). `callback(iteration, settled)` may return True to cancel,
    which gives an empty result (the reference's JobMonitor contract)."""
    global DEVICE_SOLVES
    from .amg import AmgPrecond, spectral_seed
    from .eigs import ortho_lobpcg

    n = ops.n_dofs
    dev = ops.device
    p = min(nev + guard, n)

    if n <= small_n:
        return _small_pencil_path(ops, nev, p, sigma, callback)

    def fail(iterations, ops_count, reason="noconv"):
        # Cancellation gives the empty result; numerical failure answers on the host
        # when the pencil is host-feasible (counted in HOST_SOLVES).
        if reason != "cancel" and n <= host_fallback_n:
            result = _small_pencil_path(ops, nev, p, sigma, callback)
            result.iterations += iterations
            result.op_applications += ops_count
            return result
        return _empty(n, dev, iterations, ops_count)

    if not isinstance(precond, AmgPrecond):
        return fail(0, 0)

    amat = ops.shifted(sigma).amat
    rigid_cols = min(int(precond.rigid.shape[1]), p)
    if rigid_cols >= nev:
        # Every wanted mode is rigid: known in closed form, eigenvalue exactly 0.
        DEVICE_SOLVES += 1
        return LobpcgResult(np.zeros(nev), precond.rigid[:, :nev], 0, 0,
                            residual_norms=np.zeros(nev))

    # Seed: the exact rigid modes are prepended to the answer (eigenvalue exactly 0) and
    # deflated out of the iteration; the elastic panel is warm-start columns, then the
    # coarse spectral fill, with fixed-seed gaussian noise smoothed through the
    # preconditioner as the last resort.
    gen = torch.Generator(device=dev).manual_seed(seed)
    p_e = p - rigid_cols
    nev_e = nev - rigid_cols
    cols = []
    seeded = 0
    if x0 is not None and np.size(x0):
        seeded = min(x0.shape[1], p_e)
        warm = torch.as_tensor(np.asarray(x0)[:, :seeded], dtype=torch.float64, device=dev)
        cols.append(precond.deflate(warm))
    fill = p_e - seeded
    if fill > 0:
        sp = spectral_seed(precond, fill, generator=gen)
        if sp is None:
            # Raw gaussian columns carry lambda_max-scale energy: smooth them through
            # one preconditioner application.
            z = torch.randn(n, fill, dtype=torch.float64, device=dev, generator=gen)
            sp = precond.deflate(precond.apply(amat, z))
        cols.append(sp)
    x_e = torch.cat(cols, 1)

    res, status, iters, ops_count = ortho_lobpcg(
        ops, amat, precond, x_e, nev_e, sigma, tol, max_iters, inner_iters, callback)
    if res is None:
        return fail(iters, ops_count, status)
    lam_e, x_vec, res_e = res
    DEVICE_SOLVES += 1
    lam = np.concatenate([np.zeros(rigid_cols), lam_e])
    vecs = torch.cat([precond.rigid[:, :rigid_cols], x_vec], 1)
    res_norm = np.concatenate([np.zeros(rigid_cols), res_e])
    return LobpcgResult(lam, vecs, iters, ops_count, residual_norms=res_norm)
