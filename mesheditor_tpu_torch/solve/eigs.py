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
settled leading columns are soft-locked out of W/P; a `callback` returning True cancels.
The one loop stands in for both the reference's f32 stage (solve/eigs.py:ortho_lobpcg) and
its f64 polish (solve/lobpcg.py:_polish_from_panel), and answers by their exits, decided by
`_ExitRules` in the reference's order (eigs.py:_check: NaN, then cancellation, then the
exits):
- "certified": when tol >= 3e-7 (the stage's floor, tol32 = max(tol, 3e-7)), the largest
  relative residual |K x - theta M x| / (|K x| + |sigma| |M x|) of the nev Ritz pairs under
  res_exit = min(1e-3, max(3.16e-4, sqrt(tol * 1e3))), on one iteration. The residuals are
  those of the previous iteration's pairs, one iteration behind, as the reference checks
  them. Below 3e-7 the certificate does not answer: it opens the gate, as the reference's
  need_polish64 sends such a stage on to the polish;
- "settled": the settling criterion (mesh2modes.cpp:403-410, cluster-aware) at `tol` held
  two iterations running;
- "budget": at the last iteration, every pair settled at tol_acc = max(tol, tol_accept)
  (the reference's last-iteration rule, two running, and its after-the-loop rule, one,
  folded). The polish's own 40-iteration cap is not carried over: its budget is
  `max_iters`, which this loop shares with the stage's.
The gate is where the reference's stage would hand over to its polish: the prefix settled
at tol32 two iterations running, the certificate when tol < 3e-7, or the handoff (the
prefix at tol32 stuck for 10 iterations, from iteration 16 on). It is recorded, not acted
on: the polish's third exit, "stagnated" (the prefix at `tol` stuck for 8 iterations after
the gate while every pair settles at tol_acc two running), is left out. Ported behind this
gate, it answered the 12-triangle cuboid of tests/test_torch_surface_fineness.py at
iteration 25 (the handoff opened the gate at 16, the values still converging) at 5.8e-5
off the host path, against the 1e-6 that test holds. In the reference the handoff marks
its f32 floor; this loop has none, so the handoff opens the gate mid-convergence.
Anything else is "noconv", which the caller sends to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..profile import scope

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
    """Fixed-iteration preconditioned CG for A X = B, columns independent, X0 = 0.
    `precond` maps residual panels to preconditioned panels: an object with `.apply` (the
    AMG, applied as precond.apply(apply_a, r)), a callable, or a tensor, which is an
    inverse diagonal (Jacobi)."""
    if hasattr(precond, "apply"):
        amg = precond
        precond = lambda r: amg.apply(apply_a, r)  # noqa: E731
    elif not callable(precond):
        inv_diag = precond
        precond = lambda r: inv_diag[:, None] * r  # noqa: E731
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = _col_dots(r, z)
    for _ in range(iters):
        ap = apply_a(p)
        p_ap = _col_dots(p, ap)
        alpha = torch.where(p_ap > 0, rz / torch.where(p_ap == 0, 1.0, p_ap), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
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


def _rel_residuals(kx, mx, theta, sigma: float) -> torch.Tensor:
    """Relative residuals |K x - theta M x| / (|K x| + |sigma| |M x|) of the Ritz pairs
    whose products are the columns of kx and mx (the reference's `rel`,
    eigs.py:_iter_stage). Only norms: it writes nothing the iteration uses."""
    r = kx - mx * theta
    return torch.linalg.norm(r, dim=0) / (torch.linalg.norm(kx, dim=0)
                                          + abs(sigma) * torch.linalg.norm(mx, dim=0) + 1e-300)


TOL32 = 3e-7  # the reference's f32-stage floor, tol32 = max(tol, 3e-7) (lobpcg.py:589)
_STREAK = 2  # iterations running that a settled prefix must hold
_HANDOFF_PATIENCE, _HANDOFF_FROM = 10, 16  # the stage's handoff (eigs.py:557)


class _ExitRules:
    """The exit decision of `ortho_lobpcg`, on the host, one call an iteration (module
    docstring). Plain numpy: `check` takes the iteration, its Ritz values and the nev
    relative residuals of the previous iteration's pairs, and returns the exit, "nan", or
    None to go on. After a call, `settled`, `settled_acc` and `rel_set` hold that
    iteration's settled prefixes (at tol and at tol_acc) and relative changes, and `gate`
    the iteration at which the gate opened (None while closed)."""

    def __init__(self, nev: int, tol: float, sigma: float, max_iters: int,
                 tol_accept: float = 1e-4, floor_rel: float = 1e-9):
        self.nev, self.tol, self.sigma, self.max_iters = nev, tol, sigma, max_iters
        self.floor_rel = floor_rel
        self.tol32 = max(tol, TOL32)
        self.tol_acc = max(tol, tol_accept)
        self.res_exit = min(1e-3, max(3.16e-4, (tol * 1e3) ** 0.5))
        self.prev = np.full(nev, np.inf)
        self.streak = self.streak32 = self.accept_streak = 0
        self.best, self.since = -1, 0  # growth of the prefix at tol32, until the gate
        self.gate = None
        self.settled = self.settled_acc = 0
        self.rel_set = np.full(nev, np.inf)

    def check(self, it: int, lam: np.ndarray, rel: np.ndarray):
        from .lobpcg import _settled_prefix

        nev = self.nev
        if not np.isfinite(lam[:nev]).all():
            return "nan"

        def prefix(tol):
            return _settled_prefix(lam, self.prev, nev, tol, self.sigma, self.floor_rel)

        self.settled, self.rel_set, _delta, _window = prefix(self.tol)
        settled32 = self.settled if self.tol32 == self.tol else prefix(self.tol32)[0]
        self.settled_acc = prefix(self.tol_acc)[0]
        self.prev = lam
        self.streak = self.streak + 1 if self.settled >= nev else 0
        self.streak32 = self.streak32 + 1 if settled32 >= nev else 0
        self.accept_streak = self.accept_streak + 1 if self.settled_acc >= nev else 0
        certified = bool(np.isfinite(rel[:nev]).all() and rel[:nev].max() < self.res_exit)
        if certified and self.tol >= TOL32:
            return "certified"
        if self.streak >= _STREAK:
            return "settled"
        if self.gate is None:
            if settled32 > self.best:
                self.best, self.since = settled32, 0
            else:
                self.since += 1
            if (self.streak32 >= _STREAK or certified
                    or (self.since >= _HANDOFF_PATIENCE and it >= _HANDOFF_FROM)):
                self.gate = it
        if it == self.max_iters and self.accept_streak >= 1:
            return "budget"
        return None


def ortho_lobpcg(ops, amat, precond, x_seed: torch.Tensor, nev: int, sigma: float,
                 tol: float, max_iters: int, inner_iters: int, callback=None,
                 debug: bool = False, tol_accept: float = 1e-4):
    """LOBPCG outer loop over the elastic (rigid-deflated) spectrum.

    Returns ((lam (nev,), x (n, nev), res_norm (nev,), exit), status, iterations, op_count,
    gate) with status "done" and `exit` the rule that answered ("certified", "settled" or
    "budget", module docstring), or (None, status, ...) with status in
    {"cancel", "nan", "noconv"}; `gate` is the iteration at which the gate opened, or None.

    `debug` prints one line per iteration, flushed, in the reference's format
    (eigs.py:_check): the iteration, the settled prefix of nev, the eigenvalue at the first
    unsettled index (the last when all settled) with its relative change, the largest
    relative residual the certificate read (the previous iteration's pairs) and the wall
    since the previous line. After the line of the iteration that answers, or after the
    last when none does, one `[ortho exit]` line names the exit ("noconv" for none) with the
    settled prefix at `tol` and at tol_acc and the iteration at which the gate opened ("-"
    while closed). The trace only prints what the exit rules read, so the answer is the
    same bit for bit with it on or off.

    Each iteration is a `solve/eigs/iter` span (profile.py): `solve/eigs/basis` (the Ritz
    vectors and the P block, then W's products, the projections, Cholesky-QR and the
    Rayleigh-Ritz), `solve/eigs/precond` (the residuals and the CG block) and
    `solve/eigs/read` (the host read, the exit rules, cancellation and locking).
    """
    import time

    from .lobpcg import _cancelled

    p = x_seed.shape[1]
    x = x_seed
    kx, mx = ops.kmat(x), ops.mmat(x)
    x, kx, mx = _chol_qr_m(x, kx, mx)
    theta, c = _rayleigh_ritz(x.T @ kx, x.T @ mx, p)
    s, ks, ms = x, kx, mx
    ops_count = 2
    rules = _ExitRules(nev, tol, sigma, max_iters, tol_accept)
    lock = 0
    lock_cap = max(p - _LOCK_STEP, 0)
    last_t = time.perf_counter()

    for it in range(1, max_iters + 1):
        with scope("solve/eigs/iter"):
            with scope("solve/eigs/basis"):
                x, kx, mx = s @ c, ks @ c, ms @ c
                # The certificate's residuals: the previous iteration's nev pairs, from
                # the products this iteration forms anyway.
                rel = _rel_residuals(kx[:, :nev], mx[:, :nev], theta[:nev], sigma)
                has_p = s.shape[1] > p
                if has_p:
                    c_wp = c[p:, lock:]
                    pdir, kp, mp = s[:, p:] @ c_wp, ks[:, p:] @ c_wp, ms[:, p:] @ c_wp
            with scope("solve/eigs/precond"):
                r = kx[:, lock:] - mx[:, lock:] * theta[lock:]
                w = precond.deflate(_pcg_block(amat, precond, r, inner_iters))
            with scope("solve/eigs/basis"):
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
            with scope("solve/eigs/read"):
                read = torch.cat([theta, rel])
                if ops.tp is not None:
                    # Every rank makes the host decisions below (exit, locked, done) from
                    # the group's first rank's values and residuals, so none can leave the
                    # loop while another waits in a collective, whatever the last bits of
                    # its own panels.
                    read = ops.tp.agree(read)
                    theta = read[:p]
                read = read.cpu().numpy()
                lam, rel_h = read[:p], read[p:]

                exit_rule = rules.check(it, lam, rel_h)
                if exit_rule == "nan":
                    return None, "nan", it, ops_count, rules.gate
                settled = rules.settled
                if debug:
                    now = time.perf_counter()
                    dt, last_t = now - last_t, now
                    j = min(settled, nev - 1)
                    print(f"[ortho] it={it} settled={settled}/{nev} lam_j={lam[j]:.6e} "
                          f"set_rel={rules.rel_set[j]:.2e} res_max={rel_h.max():.2e} "
                          f"dt={dt:.2f}s", flush=True)
                    if exit_rule or it == max_iters:
                        print(f"[ortho exit] it={it} exit={exit_rule or 'noconv'} "
                              f"settled={settled}/{nev} accepted={rules.settled_acc}/{nev} "
                              f"tol={tol:.1e} tol_acc={rules.tol_acc:.1e} "
                              f"gate={rules.gate or '-'}", flush=True)
                if _cancelled(ops, callback, it, settled):
                    return None, "cancel", it, ops_count, rules.gate
                if exit_rule:
                    x, kx, mx = s @ c[:, :nev], ks @ c[:, :nev], ms @ c[:, :nev]
                    res = torch.linalg.norm(kx - mx * theta[:nev], dim=0).cpu().numpy()
                    return ((lam[:nev].copy(), x, res, exit_rule), "done", it, ops_count,
                            rules.gate)
                bucket = min(max(settled - _LOCK_MARGIN, 0) // _LOCK_STEP * _LOCK_STEP,
                             lock_cap)
                lock = max(lock, bucket)
    return None, "noconv", max_iters, ops_count, rules.gate
