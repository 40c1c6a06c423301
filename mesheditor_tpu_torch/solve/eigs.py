"""Orthonormal-basis blocked LOBPCG engine for the FEM pencil (K, M), float64 on the
device (counterpart of mesheditor_tpu/solve/eigs.py).

Replaces a sparse-Cholesky shift-invert subspace iteration with LOBPCG whose correction
block W is a few steps of AMG-preconditioned CG on the shifted pencil A = K - sigma*M.

The basis [X | W | P] is kept M-orthonormal by construction: W (the preconditioned
residuals) and P (the momentum) are M-projected against X (and P against W) and CholQR'd,
so the Rayleigh-Ritz mass Gram is the identity up to roundoff and never has to whiten
anything ill-conditioned. K S and M S are carried through every linear recombination;
only W gets fresh K/M applies. Rayleigh-Ritz is a float64 Cholesky-whitened
torch.linalg.eigh on the device.

Every panel is float64, so the reference's f32-carry machinery (chunked f64-sum Grams,
the spectral-fold Rayleigh-Ritz with Newton-Schulz whitening, Sylvester refinement, the
separate f64 polish, periodic re-anchoring of the carried panels) has nothing to repair.

Reference semantics kept: the exact rigid modes are seeded and deflated by the caller;
the settling criterion (mesh2modes.cpp:403-410, cluster-aware) must hold two iterations
running; settled leading columns are soft-locked out of W/P; a `callback` returning True
cancels.
"""

from __future__ import annotations

import numpy as np
import torch

# Soft-locking schedule: lock in steps of _LOCK_STEP columns with a _LOCK_MARGIN safety
# gap below the observed settled prefix, so a transient settle regression never locks an
# unconverged column out of its W/P corrections.
_LOCK_STEP = 64
_LOCK_MARGIN = 16

_QR_RIDGE = 1e-12  # CholQR Gram ridge, relative to the unit diagonal
_LIVE_EPS = 1e-14  # projection survival threshold on squared M-norms


def _col_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(0)


def _pcg_block(apply_a, precond, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Fixed-iteration preconditioned CG for A X = B, columns independent, X0 = 0."""
    x = torch.zeros_like(b)
    r = b
    z = precond.apply(apply_a, r)
    p = z
    rz = _col_dots(r, z)
    for _ in range(iters):
        ap = apply_a(p)
        p_ap = _col_dots(p, ap)
        alpha = torch.where(p_ap > 0, rz / torch.where(p_ap == 0, 1.0, p_ap), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond.apply(apply_a, r)
        rz_new = _col_dots(r, z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz == 0, 1.0, rz), 0.0)
        p = z + beta * p
        rz = rz_new
    return x


def _project_out(x, kx, mx, w, kw, mw):
    """Remove the M-projection of w onto the M-orthonormal block x; the carried products
    transform alongside."""
    q = mx.T @ w
    return w - x @ q, kw - kx @ q, mw - mx @ q


def _kill_collapsed(pre2, w, kw, mw):
    """Zero columns whose M-norm collapsed under projection: they lay inside the
    projected-out span, and normalizing them would amplify roundoff into the basis."""
    live = (_col_dots(w, mw) > _LIVE_EPS * torch.clamp(pre2, min=1e-300)).to(w.dtype)
    return w * live, kw * live, mw * live


def _chol_qr_m(w, kw, mw, passes: int = 2):
    """M-orthonormalize the block w (and its carried products) by two CholQR passes.
    Dependent columns become exact zeros, which the Rayleigh-Ritz parks above the window:
    the first pass drops columns with no mass at all; a later pass drops columns whose
    post-whitening norm is at the ridge scale (they were inside the span of the others)."""
    k = w.shape[1]
    if k == 0:
        return w, kw, mw
    eye = torch.eye(k, dtype=w.dtype, device=w.device)
    for ipass in range(passes):
        cn = _col_dots(w, mw)
        kill_rel = 1e-20 if ipass == 0 else 1e-4
        live = cn > kill_rel * torch.clamp(cn.max(), min=1e-300)
        d = torch.where(live, torch.rsqrt(torch.where(live, cn, 1.0)), 0.0)
        w, kw, mw = w * d, kw * d, mw * d
        g = w.T @ mw
        g = 0.5 * (g + g.T)
        mask = live[:, None] & live[None, :]
        g = torch.where(mask, g, 0.0) + torch.diag(torch.where(live, _QR_RIDGE, 1.0).to(g.dtype))
        ell = torch.linalg.cholesky(g)
        c = torch.linalg.solve_triangular(ell, eye, upper=False).T * live.to(g.dtype)
        w, kw, mw = w @ c, kw @ c, mw @ c
    return w, kw, mw


def _rayleigh_ritz(a: torch.Tensor, b: torch.Tensor, p_want: int):
    """Lowest p_want Ritz pairs of the (q, q) pencil (a, b), b ~ I. Dead (zeroed) basis
    columns get a unit mass and an above-window stiffness so they sort past the window.
    Returns (theta (p_want,) ascending, c (q, p_want) b-orthonormal)."""
    a = 0.5 * (a + a.T)
    b = 0.5 * (b + b.T)
    dead = torch.diagonal(b) < 0.5
    amax = torch.clamp(torch.diagonal(a).abs().max(), min=1.0)
    a = a + torch.diag(torch.where(dead, 10.0 * amax, 0.0))
    b = b + torch.diag(dead.to(b.dtype))
    ell = torch.linalg.cholesky(b)
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    linv = torch.linalg.solve_triangular(ell, eye, upper=False)
    h = linv @ a @ linv.T
    theta, v = torch.linalg.eigh(0.5 * (h + h.T))
    return theta[:p_want], linv.T @ v[:, :p_want]


def ortho_lobpcg(ops, amat, precond, x_seed: torch.Tensor, nev: int, sigma: float,
                 tol: float, max_iters: int, inner_iters: int, callback=None):
    """LOBPCG outer loop over the elastic (rigid-deflated) spectrum.

    Returns ((lam (nev,), x (n, nev), res_norm (nev,)), status, iterations, op_count)
    with status "done", or (None, status, ...) with status in {"cancel", "nan", "noconv"}.
    """
    from .lobpcg import _cancelled, _settled_prefix

    p = x_seed.shape[1]
    x = x_seed
    kx, mx = ops.kmat(x), ops.mmat(x)
    x, kx, mx = _chol_qr_m(x, kx, mx)
    theta, c = _rayleigh_ritz(x.T @ kx, x.T @ mx, p)
    s, ks, ms = x, kx, mx
    ops_count = 2
    prev = np.full(nev, np.inf)
    streak = 0
    lock = 0
    lock_cap = max(p - _LOCK_STEP, 0)
    floor_rel = 1e-9

    for it in range(1, max_iters + 1):
        x, kx, mx = s @ c, ks @ c, ms @ c
        has_p = s.shape[1] > p
        if has_p:
            c_wp = c[p:, lock:]
            pdir, kp, mp = s[:, p:] @ c_wp, ks[:, p:] @ c_wp, ms[:, p:] @ c_wp
        r = kx[:, lock:] - mx[:, lock:] * theta[lock:]
        w = precond.deflate(_pcg_block(amat, precond, r, inner_iters))
        kw, mw = ops.kmat(w), ops.mmat(w)
        ops_count += 2 + inner_iters
        pre2 = _col_dots(w, mw)
        w, kw, mw = _project_out(x, kx, mx, w, kw, mw)
        w, kw, mw = _kill_collapsed(pre2, w, kw, mw)
        w, kw, mw = _chol_qr_m(w, kw, mw)
        blocks = [(x, kx, mx), (w, kw, mw)]
        if has_p:
            pre2 = _col_dots(pdir, mp)
            pdir, kp, mp = _project_out(x, kx, mx, pdir, kp, mp)
            pdir, kp, mp = _project_out(w, kw, mw, pdir, kp, mp)
            pdir, kp, mp = _kill_collapsed(pre2, pdir, kp, mp)
            blocks.append(_chol_qr_m(pdir, kp, mp))
        s, ks, ms = (torch.cat(t, 1) for t in zip(*blocks))
        theta, c = _rayleigh_ritz(s.T @ ks, s.T @ ms, p)
        if ops.tp is not None:
            # Every rank makes the host decisions below (settled, locked, done) from the
            # group's first rank's values, so none can leave the loop while another waits
            # in a collective, whatever the last bits of its own panels.
            theta = ops.tp.agree(theta)

        lam = theta.cpu().numpy()
        if not np.isfinite(lam[:nev]).all():
            return None, "nan", it, ops_count
        settled, _rel, _delta, _window = _settled_prefix(lam, prev, nev, tol, sigma,
                                                         floor_rel)
        prev = lam
        if _cancelled(ops, callback, it, settled):
            return None, "cancel", it, ops_count
        streak = streak + 1 if settled >= nev else 0
        if streak >= 2:
            x, kx, mx = s @ c[:, :nev], ks @ c[:, :nev], ms @ c[:, :nev]
            res = torch.linalg.norm(kx - mx * theta[:nev], dim=0).cpu().numpy()
            return (lam[:nev].copy(), x, res), "done", it, ops_count
        bucket = min(max(settled - _LOCK_MARGIN, 0) // _LOCK_STEP * _LOCK_STEP, lock_cap)
        lock = max(lock, bucket)
    return None, "noconv", max_iters, ops_count
