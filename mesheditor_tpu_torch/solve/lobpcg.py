"""Generalized eigensolver entry for the FEM pencil (K, M) (counterpart of
mesheditor_tpu/solve/lobpcg.py).

`lobpcg_pencil` takes the pencil in either of the reference's two forms: element operators,
`lobpcg_pencil(ops, nev, *, sigma, precond, ...)`, or operator callables,
`lobpcg_pencil(kmat, mmat, k_diag, m_diag, n, nev, *, op_state, kmat_pc, mmat_pc, ...)`.
The callable form is routed as the reference routes it (lobpcg.py:486-503): an
ElementOperators `op_state` goes to the element form's paths below when n <= small_n or
`kmat_pc` is given; any other pencil goes to the CLOSURE engine, `_lobpcg_legacy`: an
all-float64 LOBPCG over the callables with a Jacobi-preconditioned CG inner solve and a
host Rayleigh-Ritz, which answers or gives the empty result, never the host solve.

The element form has two ways to an answer, chosen as the reference chooses them:

- the DEVICE path: the float64 LOBPCG engine (solve/eigs.py) with the AMG preconditioner,
  for pencils above `small_n` dofs. It answers by the reference's exits, its f32 stage's
  and its f64 polish's on one loop: the residual certificate when `tol` >= 3e-7
  ("certified"), every pair settled at `tol` two iterations running ("settled"), or every
  pair moving less than `tol_accept` when the `max_iters` budget is spent ("budget"). The
  polish's stagnation exit is left out (eigs.py says why);
- the HOST path: scipy's sparse shift-invert Lanczos (eigsh with sigma) on the assembled
  CSR pencil, for pencils at or below `small_n`, and as the fallback when the device path
  has no preconditioner or answers by none of its exits and the pencil is host-feasible
  (n <= host_fallback_n).

Which path answered is never silent: DEVICE_SOLVES, HOST_SOLVES and CLOSURE_SOLVES count
the solves each path answered in this process, and DEVICE_EXITS the device engine's answers
by exit; each LobpcgResult names its own (`exit`) and the iteration at which the engine's
gate opened.

On an element-sharded pencil (`ops.tp` set) every rank of the group runs the same calls.
The host path then solves the gathered whole pencil and every rank takes the answer of the
group's first rank; the device path takes its eigenvalue estimates and residuals, and
with them every host decision (settled and accepted counts, certificate, gate, locking,
exit, NaN), from that rank too, and agrees on cancellation (eigs.py). So no rank can leave
a collective that another still waits in.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

DEVICE_SOLVES = 0  # solves the float64 device engine answered
HOST_SOLVES = 0  # solves the host shift-invert answered (small pencils and fallbacks)
CLOSURE_SOLVES = 0  # solves the closure engine (_lobpcg_legacy) answered
# engine answers by exit (eigs.py)
DEVICE_EXITS = {"certified": 0, "settled": 0, "budget": 0}


@dataclass
class LobpcgResult:
    eigenvalues: np.ndarray  # (nev,), ascending; empty when the solve failed or was cancelled
    eigenvectors: torch.Tensor  # (n, nev) float64, M-orthonormal, on the pencil's device
    iterations: int = 0
    op_applications: int = 0  # pencil panels applied
    residual_norms: Optional[np.ndarray] = None
    # the engine's exit (DEVICE_EXITS), "rigid", "host", "closure" (the closure engine
    # settled), or "" when empty
    exit: str = ""
    gate: Optional[int] = None  # the engine's iteration at which its gate opened


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
    # A fixed start vector: ARPACK's own comes from a process-wide generator, so the answer
    # (its last bits, the modes' signs) would follow the shift-invert solves run before it.
    v0 = np.random.default_rng(0).uniform(-1.0, 1.0, n)
    try:
        vals, vecs = spla.eigsh(k, k=p, M=m, sigma=sigma, which="LM", v0=v0)
    except (RuntimeError, ValueError, spla.ArpackError):
        vals, vecs = np.zeros(0), np.zeros((n, 0))
    order = np.argsort(vals)
    vals = vals[order][:nev]
    vecs = torch.as_tensor(vecs[:, order][:, :nev], device=ops.device)
    if ops.tp is not None:  # threaded BLAS may part the ranks' last bits: take the first rank's
        vals = ops.tp.agree(torch.as_tensor(vals, device=ops.device)).cpu().numpy()
        vecs = ops.tp.agree(vecs)
    if vals.size == 0:
        return _empty(n, ops.device, 0, 1)
    if _cancelled(ops, callback, 1, nev):
        return _empty(n, ops.device, 1, 1)
    HOST_SOLVES += 1
    return LobpcgResult(vals.copy(), vecs, 1, 1, residual_norms=np.zeros(nev), exit="host")


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
    kmat,
    mmat=None,
    k_diag: Optional[torch.Tensor] = None,
    m_diag: Optional[torch.Tensor] = None,
    n: Optional[int] = None,
    nev: Optional[int] = None,
    *,
    op_state=None,
    kmat_pc: Optional[Callable] = None,
    mmat_pc: Optional[Callable] = None,
    sigma: float,
    x0: Optional[np.ndarray] = None,
    guard: int = 15,
    tol: float = 1e-8,
    max_iters: int = 100,
    inner_iters: int = 24,
    refresh_every: int = 25,
    seed: int = 20260710,
    callback: Optional[Callable[[int, int], bool]] = None,
    precond=None,
    small_n: int = 9000,
    host_fallback_n: int = 120_000,
    tol_accept: float = 1e-4,
    debug: Optional[bool] = None,
) -> LobpcgResult:
    """Lowest `nev` eigenpairs of K x = lambda M x, the pencil in either form:

    - element operators, `lobpcg_pencil(ops, nev, *, sigma, precond, ...)`: the device
      engine with the AMG `precond`, or the host path (module docstring);
    - operator callables, `lobpcg_pencil(kmat, mmat, k_diag, m_diag, n, nev, *, op_state,
      kmat_pc, mmat_pc, ...)`: kmat/mmat apply K and M to (n, p) float64 panels, called as
      kmat(op_state, x) when `op_state` is given and as kmat(x) when not; k_diag/m_diag are
      the pencil's diagonals (tensors; the closure engine runs on their device). An
      ElementOperators `op_state` with n <= small_n, or with `kmat_pc` given, is solved by
      the element form on `op_state` (with `precond`), as the reference routes it; any
      other pencil by the closure engine (`_lobpcg_legacy`), whose inner CG runs on
      K - sigma*M in float64, or in float32 on kmat_pc(op_state, x) - sigma *
      mmat_pc(op_state, x) when both are given.

    `sigma` (negative) shifts the preconditioner pencil. `x0` (n, >=1) seeds the leading
    columns (the element engine's elastic ones; a warm start). `callback(iteration,
    settled)` may return True to cancel, which gives an empty result (the reference's
    JobMonitor contract). `tol_accept` is the device engine's acceptance floor for its
    "budget" exit (used as max(tol, tol_accept), as the reference's polish does).
    `refresh_every` is the closure engine's: it applies K and M afresh to the Ritz vectors
    every that many iterations (0: never). `debug` (default: the MESHEDITOR_TPU_DEBUG_EIG
    env var, as in the reference) prints the engine's per-iteration trace (`[ortho]` lines
    from the device engine, eigs.py:ortho_lobpcg; `[eig]` lines from the closure engine);
    the answer does not change."""
    from ..fem.assembly import ElementOperators

    element = dict(sigma=sigma, precond=precond, x0=x0, guard=guard, tol=tol,
                   max_iters=max_iters, inner_iters=inner_iters, seed=seed,
                   callback=callback, small_n=small_n, host_fallback_n=host_fallback_n,
                   debug=debug, tol_accept=tol_accept)
    if isinstance(kmat, ElementOperators):
        # The element form: the second argument is nev.
        wanted = mmat if nev is None else nev
        if ((mmat is None) == (nev is None) or op_state is not None or kmat_pc is not None
                or mmat_pc is not None or any(v is not None for v in (k_diag, m_diag, n))):
            raise TypeError("the element form is lobpcg_pencil(ops, nev, *, sigma, ...)")
        return _element_pencil(kmat, wanted, **element)
    if not (callable(kmat) and callable(mmat)) or any(
            v is None for v in (k_diag, m_diag, n, nev)):
        raise TypeError("lobpcg_pencil takes (ops, nev, ...) or (kmat, mmat, k_diag, m_diag, "
                        "n, nev, ...) with kmat and mmat callable")
    if isinstance(op_state, ElementOperators) and (n <= small_n or kmat_pc is not None):
        return _element_pencil(op_state, nev, **element)
    return _lobpcg_legacy(
        kmat, mmat, k_diag, m_diag, n, nev, op_state=op_state, kmat_pc=kmat_pc,
        mmat_pc=mmat_pc, sigma=sigma, x0=x0, guard=guard, tol=tol, max_iters=max_iters,
        inner_iters=inner_iters, refresh_every=refresh_every, seed=seed, callback=callback,
        debug=debug,
    )


def _element_pencil(ops, nev: int, *, sigma, precond, x0, guard, tol, max_iters, inner_iters,
                    seed, callback, small_n, host_fallback_n, debug,
                    tol_accept) -> LobpcgResult:
    """The element form of lobpcg_pencil: the host path at n <= small_n, else the device
    engine with the AMG `precond` (its fallback the host path)."""
    global DEVICE_SOLVES
    from .amg import AmgPrecond, spectral_seed
    from .eigs import ortho_lobpcg

    n = ops.n_dofs
    dev = ops.device
    p = min(nev + guard, n)

    if n <= small_n:
        return _small_pencil_path(ops, nev, p, sigma, callback)

    def fail(iterations, ops_count, reason="noconv", gate=None):
        # Cancellation gives the empty result; numerical failure answers on the host
        # when the pencil is host-feasible (counted in HOST_SOLVES).
        if reason != "cancel" and n <= host_fallback_n:
            result = _small_pencil_path(ops, nev, p, sigma, callback)
            result.iterations += iterations
            result.op_applications += ops_count
        else:
            result = _empty(n, dev, iterations, ops_count)
        result.gate = gate
        return result

    if not isinstance(precond, AmgPrecond):
        return fail(0, 0)

    amat = ops.shifted(sigma).amat
    rigid_cols = min(int(precond.rigid.shape[1]), p)
    if rigid_cols >= nev:
        # Every wanted mode is rigid: known in closed form, eigenvalue exactly 0.
        DEVICE_SOLVES += 1
        return LobpcgResult(np.zeros(nev), precond.rigid[:, :nev], 0, 0,
                            residual_norms=np.zeros(nev), exit="rigid")

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

    if debug is None:
        debug = bool(os.environ.get("MESHEDITOR_TPU_DEBUG_EIG"))
    res, status, iters, ops_count, gate = ortho_lobpcg(
        ops, amat, precond, x_e, nev_e, sigma, tol, max_iters, inner_iters, callback, debug,
        tol_accept)
    if res is None:
        return fail(iters, ops_count, status, gate)
    lam_e, x_vec, res_e, exit_rule = res
    DEVICE_SOLVES += 1
    DEVICE_EXITS[exit_rule] += 1
    lam = np.concatenate([np.zeros(rigid_cols), lam_e])
    vecs = torch.cat([precond.rigid[:, :rigid_cols], x_vec], 1)
    res_norm = np.concatenate([np.zeros(rigid_cols), res_e])
    return LobpcgResult(lam, vecs, iters, ops_count, residual_norms=res_norm, exit=exit_rule,
                        gate=gate)


# ---- the closure engine: operator callables, float64 throughout ----


def _solve_reduced(a: np.ndarray, b: np.ndarray, p_want: int):
    """Host Rayleigh-Ritz (the closure engine's): lowest p_want Ritz pairs of (a, b).

    The closure basis is not M-orthonormal and its dead columns are zeros, so b may be far
    from I and singular: whiten by b's eigendecomposition with a loose cutoff (whitening by
    1/sqrt of a barely-alive Gram eigenvalue amplifies noise into the spectrum); masked
    directions get a scale-relative above-spectrum penalty so they sort past the wanted
    window while LAPACK never sees values spanning hundreds of orders of magnitude."""
    a = 0.5 * (a + a.T)
    b = 0.5 * (b + b.T)
    bw, bu = np.linalg.eigh(b)
    b_max = max(float(np.abs(bw).max()), 1e-300)
    good = bw > 1e-8 * b_max
    inv_sqrt = np.where(good, 1.0 / np.sqrt(np.where(good, bw, 1.0)), 0.0)
    w = bu * inv_sqrt[None, :]
    h = w.T @ a @ w
    h = 0.5 * (h + h.T)
    penalty = 10.0 * float(np.abs(h).max()) + 1.0
    h[np.diag_indices_from(h)] += np.where(good, 0.0, penalty)
    theta, q = np.linalg.eigh(h)
    c = w @ q
    return theta[:p_want], np.ascontiguousarray(c[:, :p_want])


def _normalize_cols(block: torch.Tensor, mb: torch.Tensor):
    """Scale columns to unit M-norm; columns with no mass become exact zeros."""
    from .eigs import _col_dots

    cn = _col_dots(block, mb)
    live = cn > 1e-300
    d = torch.where(live, torch.rsqrt(torch.where(live, cn, 1.0)), 0.0)
    return block * d, mb * d


_CLOSURE_FLOOR = 1e-9  # the settling rule's absolute floor, relative to the window


def _lobpcg_legacy(
    kmat, mmat, k_diag, m_diag, n, nev, *, op_state, kmat_pc, mmat_pc, sigma, x0,
    guard, tol, max_iters, inner_iters, refresh_every, seed, callback, debug=None,
):
    """The closure engine (the reference's `_lobpcg_legacy`, lobpcg.py:727-914): LOBPCG over
    operator callables, every panel float64 on the device of `k_diag`, for pencils given
    without element operators.

    The basis is [X | W | P]: W is the residual through `inner_iters` steps of
    Jacobi-preconditioned CG on K - sigma*M (float64), or on kmat_pc - sigma*mmat_pc in
    float32 when those are given (the residual goes down to float32 and the correction
    back up, as the reference casts them); W and P are M-projected against X, and a column
    whose M-norm collapses under the projection (below 1e-14 of its norm before) is zeroed,
    not removed. K S and M S are carried through the recombinations and recomputed from
    the Ritz vectors every `refresh_every` iterations. The Rayleigh-Ritz is on the host
    (`_solve_reduced`): one round trip an iteration, the reduced pencil down and the
    coefficients up. The reference sends the coefficients (and at exit the recombination)
    up in float32 and brings B down in float32, which spares its device link; here both stay
    float64. The answer is the settled prefix (`_settled_prefix`, floor 1e-9) reaching nev;
    a cancel, a NaN eigenvalue or a spent `max_iters` gives the empty result, with no host
    solve. Panels applied: 3 at the start, 2 + 2 * inner_iters an iteration, 2 a refresh.
    Without `x0`, the start panel is gaussian from a torch.Generator seeded by `seed` on the
    device (JAX's key stream cannot be matched); `x0`'s columns replace its leading ones.
    """
    global CLOSURE_SOLVES
    from .eigs import _LIVE_EPS, _col_dots, _pcg_block

    f64 = torch.float64
    k_diag = torch.as_tensor(k_diag, dtype=f64)
    m_diag = torch.as_tensor(m_diag, dtype=f64, device=k_diag.device)
    dev = k_diag.device
    p = min(nev + guard, n)

    inv_diag = 1.0 / (k_diag - sigma * m_diag)
    inv_diag_f32 = inv_diag.to(torch.float32)

    if op_state is None:
        _kmat = lambda ops, x: kmat(x)  # noqa: E731
        _mmat = lambda ops, x: mmat(x)  # noqa: E731
    else:
        _kmat, _mmat = kmat, mmat

    if kmat_pc is not None:
        def precond(r):
            def apply_shifted(x):
                return kmat_pc(op_state, x) - sigma * mmat_pc(op_state, x)

            z = _pcg_block(apply_shifted, inv_diag_f32, r.to(torch.float32), inner_iters)
            return z.to(r.dtype)
    else:
        def precond(r):
            def apply_shifted(x):
                return _kmat(op_state, x) - sigma * _mmat(op_state, x)

            return _pcg_block(apply_shifted, inv_diag, r, inner_iters)

    def init_stage(x):
        mx = _mmat(op_state, x)
        x, mx = _normalize_cols(x, mx)
        kx = _kmat(op_state, x)
        return x, kx, mx, x.T @ kx, x.T @ mx

    def fused(s_in, ks_in, ms_in, c, theta):
        c_wp = torch.cat([torch.zeros_like(c[:p]), c[p:]])
        x, kx, mx = s_in @ c, ks_in @ c, ms_in @ c
        pdir, kp, mp = s_in @ c_wp, ks_in @ c_wp, ms_in @ c_wp
        r = kx - mx * theta
        res_norm = torch.sqrt(_col_dots(r, r))
        w = precond(r)
        if kmat_pc is not None:
            mw_pre = mmat_pc(op_state, w.to(torch.float32)).to(w.dtype)
        else:
            mw_pre = _mmat(op_state, w)
        pre2 = _col_dots(w, mw_pre)
        w = w - x @ (mx.T @ w)
        mw = _mmat(op_state, w)
        post2 = _col_dots(w, mw)
        live = post2 > _LIVE_EPS * torch.clamp(pre2, min=1e-300)
        w = torch.where(live, w, 0.0)
        mw = torch.where(live, mw, 0.0)
        w, mw = _normalize_cols(w, mw)
        kw = _kmat(op_state, w)
        pre2p = _col_dots(pdir, mp)
        q = mx.T @ pdir
        pdir_o = pdir - x @ q
        mp = mp - mx @ q
        kp = kp - kx @ q
        post2p = _col_dots(pdir_o, mp)
        livep = post2p > _LIVE_EPS * torch.clamp(pre2p, min=1e-300)
        pdir_o = torch.where(livep, pdir_o, 0.0)
        mp = torch.where(livep, mp, 0.0)
        kp = torch.where(livep, kp, 0.0)
        cn = _col_dots(pdir_o, mp)
        livec = cn > 1e-300
        d = torch.where(livec, 1.0 / torch.sqrt(torch.where(livec, cn, 1.0)), 0.0)
        pdir_o, mp, kp = pdir_o * d, mp * d, kp * d
        s = torch.cat([x, w, pdir_o], 1)
        ks = torch.cat([kx, kw, kp], 1)
        ms = torch.cat([mx, mw, mp], 1)
        return s, ks, ms, s.T @ ks, s.T @ ms, res_norm

    def upload(a):
        return torch.as_tensor(a, dtype=f64, device=dev)

    def empty(iterations, ops_count):
        return _empty(n, dev, iterations, ops_count)

    if debug is None:
        debug = bool(os.environ.get("MESHEDITOR_TPU_DEBUG_EIG"))

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, p, dtype=f64, device=dev, generator=gen)
    if x0 is not None and np.size(x0):
        seeded = min(x0.shape[1], p)
        x[:, :seeded] = upload(np.asarray(x0)[:, :seeded])

    x, kx, mx, a, b = init_stage(x)
    theta_np, c_np = _solve_reduced(a.cpu().numpy(), b.cpu().numpy(), p)
    zeros = torch.zeros(n, 2 * p, dtype=f64, device=dev)
    s, ks, ms = (torch.cat([t, zeros], 1) for t in (x, kx, mx))
    cu = np.zeros((3 * p, p))
    cu[:p] = c_np
    theta_up = theta_np
    ops_count = 3
    prev = np.full(p, np.inf)
    iterations = 0

    for it in range(max_iters):
        s, ks, ms, a_d, b_d, res_norm = fused(s, ks, ms, upload(cu), upload(theta_up))
        ops_count += 2 + 2 * inner_iters
        theta_np, c_np = _solve_reduced(a_d.cpu().numpy(), b_d.cpu().numpy(), p)
        iterations = it + 1
        lam = theta_np
        if not np.isfinite(lam[:nev]).all():
            return empty(iterations, ops_count)
        cu = c_np
        theta_up = theta_np
        refreshed = bool(refresh_every) and (it + 1) % refresh_every == 0
        if refreshed:
            # Recombine the Ritz vectors and P, then apply K and M to the Ritz vectors
            # afresh: the carried products drift from the basis over many recombinations.
            c = upload(c_np)
            c_wp = torch.cat([torch.zeros_like(c[:p]), c[p:]])
            x, pdir, kp, mp = s @ c, s @ c_wp, ks @ c_wp, ms @ c_wp
            kx, mx = _kmat(op_state, x), _mmat(op_state, x)
            zero = torch.zeros_like(x)
            s = torch.cat([x, pdir, zero], 1)
            ks = torch.cat([kx, kp, zero], 1)
            ms = torch.cat([mx, mp, zero], 1)
            cu = np.zeros((3 * p, p))
            cu[:p] = np.eye(p)
            ops_count += 2

        settled, rel, delta, window = _settled_prefix(lam, prev, nev, tol, sigma,
                                                      _CLOSURE_FLOOR)
        prev = lam
        if debug:
            j = min(settled, nev - 1)
            print(
                f"[eig] it={iterations} settled={settled}/{nev} "
                f"blocker: lam={lam[j]:.6e} delta={delta[j]:.3e} rel={rel[j]:.3e} "
                f"window={window:.3e}",
                flush=True,
            )
        if callback is not None and callback(iterations, settled):
            return empty(iterations, ops_count)
        if settled >= nev:
            # After a refresh the Ritz vectors are the basis's leading columns.
            x_out = s[:, :nev] if refreshed else s @ upload(c_np[:, :nev])
            CLOSURE_SOLVES += 1
            return LobpcgResult(lam[:nev].copy(), x_out, iterations, ops_count,
                                residual_norms=res_norm[:nev].cpu().numpy(), exit="closure")
    return empty(iterations, ops_count)
