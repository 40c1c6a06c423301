"""fem.py's modal solve for a mesh whose dense factorisation does not fit on one card (the
falling scene's ball at bbox/24: 199,659 dofs, 320 GB dense in float64). The elements, the
assembly, the degenerate-element rule, the excitation rule and the post-processing are
fem.py's own functions; only the lowest eigenpairs are found another way.

The six rigid motions, K's null space, are the six lowest pairs, at zero (they lie under
the band, as fem.py's rigid pairs do); the rest are M-orthogonal to them. The pencil is
shifted as fem.py shifts it, A = K - sigma M with sigma = -(2 pi f_min)^2, so A is positive
definite, and its lowest pairs in that complement are found by block LOBPCG: the basis
[X, W, P] (W the residuals solved to 1e-2 by conjugate gradients, P the last step less its
part in the block before it), M-orthonormalised twice through its Gram matrix's
eigenvectors (directions under `cut` of the largest dropped), then Rayleigh-Ritz on A. The
conjugate gradients' preconditioner is a two-level p-multigrid V-cycle: Chebyshev smoothing
on A's diagonal (degree 4 over [0.033, 1.1] of the largest eigenvalue of D^-1 A, estimated
by power iteration), and an exact solve on the linear (corner) space of the same tets, the
Galerkin product P^T A P factored by a dense pivoted LU (P interpolates corner values to the
edge midpoints). The pairs have converged when every wanted one has a residual
r = A x - mu M x with sqrt(r^T A^-1 r / mu) under `tol`, 1e-8, A^-1 r taken from the
preconditioning solve (in the 2-norm, the rounding of A x on a thin body's stiffest
elements alone reads 1e-7; in this norm it levels out at 3e-9 on the scene's block). The
eigenvalues are then good to about tol^2, a vector to tol over its relative gap to the next
mode.

Written from the textbook method, not from the program (whose eigensolve is LOBPCG under a
smoothed-aggregation AMG of its own). `dtype` float64 is the reference; float32 (every
element, operator and iteration, TF32 off) is its lower-precision control.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from . import fem

CHEBYSHEV_DEGREE = 4
CHEBYSHEV_LOW = 0.03  # the smoothed band's low end, as a share of its top
INNER_RTOL, INNER_ITERS = 1e-2, 60  # the preconditioning solve of each residual


def prolongation(kept, n_points: int, touched):
    """The interpolation P (touched dofs x corner dofs) of the linear space on the corners
    of `kept` into the quadratic one (fem.quadratic_nodes's numbering): a corner keeps its
    value, an edge midpoint takes the mean of its two ends."""
    nodes, n_nodes = fem.quadratic_nodes(kept, n_points)
    corners = np.unique(kept)
    col = np.full(n_points, -1)
    col[corners] = np.arange(len(corners))
    mids = nodes[:, 4:].ravel()  # (E * 6,), edge e of a tet at 6 t + e
    ends = np.stack([kept[:, [i for i, _ in fem.EDGES]].ravel(),
                     kept[:, [j for _, j in fem.EDGES]].ravel()], 1)
    mids, first = np.unique(mids, return_index=True)  # an edge shared by tets, once
    ends = col[ends[first]]
    rows = np.concatenate([corners, mids, mids])
    cols = np.concatenate([col[corners], ends[:, 0], ends[:, 1]])
    vals = np.concatenate([np.ones(len(corners)), np.full(2 * len(mids), 0.5)])
    p = sp.csr_matrix((vals, (rows, cols)), shape=(n_nodes, len(corners)))
    return sp.kron(p, sp.eye(3), format="csr")[touched]


class TwoLevel:
    """The V-cycle preconditioner of A (scipy CSR) with the corner space's P."""

    def __init__(self, a, p, tdt, dev):
        import torch

        from .fem import _torch_sparse

        self.a = _torch_sparse(a, tdt, dev)
        self.p = _torch_sparse(p, tdt, dev)
        self.pt = _torch_sparse(p.T.tocsr(), tdt, dev)
        self.dinv = torch.as_tensor(1.0 / a.diagonal(), dtype=tdt, device=dev)[:, None]
        coarse = torch.as_tensor((p.T @ a @ p).toarray(), dtype=tdt, device=dev)
        # Pivoted: float32 rounding may leave the product indefinite.
        self.lu = torch.linalg.lu_factor(coarse)
        del coarse
        gen = torch.Generator(device=dev).manual_seed(20261018)
        v = torch.randn(a.shape[0], 1, generator=gen, dtype=tdt, device=dev)
        for _ in range(20):
            w = self.dinv * (self.a @ v)
            top = float(w.norm() / v.norm())
            v = w / w.norm()
        self.hi = 1.1 * top
        self.lo = CHEBYSHEV_LOW * self.hi

    def smooth(self, r):
        """Degree-CHEBYSHEV_DEGREE Chebyshev iteration for A x = r from x = 0."""
        theta, delta = 0.5 * (self.hi + self.lo), 0.5 * (self.hi - self.lo)
        sigma = theta / delta
        rho = 1.0 / sigma
        d = self.dinv * r / theta
        x = d
        for _ in range(CHEBYSHEV_DEGREE - 1):
            r = r - self.a @ d
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * (self.dinv * r)
            x = x + d
            rho = rho_new
        return x

    def __call__(self, r):
        import torch

        x = self.smooth(r)
        c = torch.linalg.lu_solve(*self.lu, self.pt @ (r - self.a @ x))
        x = x + self.p @ c
        return x + self.smooth(r - self.a @ x)

    def solve(self, b, rtol: float, max_iters: int):
        """A x = b column by column by conjugate gradients under the V-cycle, until every
        column's residual is under `rtol` of its right-hand side."""
        import torch

        x = b * 0
        r = b
        z = self(r)
        d, rz = z, (r * z).sum(0)
        goal = rtol * b.norm(dim=0)
        for _ in range(max_iters):
            ad = self.a @ d
            dad = (d * ad).sum(0)
            alpha = torch.where(dad > 0, rz / torch.where(dad > 0, dad, 1), 0)
            x, r = x + alpha * d, r - alpha * ad
            if bool((r.norm(dim=0) <= goal).all()):
                break
            z = self(r)
            rz, rz_prev = (r * z).sum(0), rz
            d = z + torch.where(rz_prev > 0, rz / torch.where(rz_prev > 0, rz_prev, 1), 0) * d
        return x


def rigid_motions(points, kept, nodes, n_nodes: int, touched):
    """The six rigid motions (translations, then rotations about the origin) at the
    touched dofs, (n, 6): the null space of K."""
    pos = np.zeros((n_nodes, 3))
    pos[:len(points)] = points
    for e, (i, j) in enumerate(fem.EDGES):
        pos[nodes[:, 4 + e]] = 0.5 * (points[kept[:, i]] + points[kept[:, j]])
    cols = []
    for axis in np.eye(3):
        cols.append(np.broadcast_to(axis, pos.shape).ravel())
    for axis in np.eye(3):
        cols.append(np.cross(axis, pos).ravel())
    return np.stack(cols, 1)[touched]


def _orthonormal(q, m_t, cut: float, rigid):
    """An M-orthonormal basis of span(q) M-orthogonal to `rigid` (M-orthonormal), twice
    through the Gram matrix's eigenvectors."""
    import torch

    norm = q.norm(dim=0, keepdim=True)
    q = q / torch.where(norm > 0, norm, 1)  # a zero column stays zero, and is dropped
    for _ in range(2):
        q = q - rigid @ (rigid.T @ (m_t @ q))
        g = q.T @ (m_t @ q)
        s, v = torch.linalg.eigh(0.5 * (g + g.T))
        keep = s > cut * s.max()
        q = q @ (v[:, keep] / s[keep].sqrt())
    return q


def lowest_pairs(kk, mm, p, rigid, n_eig: int, sigma: float, dtype, tol: float | None = None,
                 max_iters: int | None = None):
    """The n_eig lowest eigenpairs of K x = lam M x (ascending; vectors M-orthonormal): the
    six rigid motions `rigid` at lam = 0, then the lowest n_eig - 6 of the M-orthogonal
    complement by block LOBPCG on A = K - sigma M under the two-level V-cycle.
    `lowest_pairs.last` records the iterations taken and the largest residual."""
    import torch

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    tdt = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    f64 = tdt == torch.float64
    tol = tol if tol is not None else (1e-8 if f64 else 1e-4)
    max_iters = max_iters if max_iters is not None else (200 if f64 else 50)
    cut = 1e-13 if f64 else 1e-6
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        a = (kk - sigma * mm).tocsr()
        prec = TwoLevel(a, p, tdt, dev)
        m_t = fem._torch_sparse(mm, tdt, dev)
        r6 = torch.as_tensor(rigid, dtype=tdt, device=dev)
        g6 = torch.linalg.cholesky(r6.T @ (m_t @ r6))
        r6 = torch.linalg.solve_triangular(g6, r6.T, upper=False).T  # M-orthonormal
        n, n_eig = a.shape[0], n_eig - r6.shape[1]
        b = min(n - 1 - r6.shape[1], 2 * n_eig + 32)  # a guard as wide as the wanted block
        gen = torch.Generator(device=dev).manual_seed(20261017)
        x = torch.randn(n, b, generator=gen, dtype=tdt, device=dev)
        step = None
        worst = float("inf")
        for it in range(max_iters):
            parts = [x] if step is None else [x, w, step]
            q = _orthonormal(torch.cat(parts, 1), m_t, cut, r6)
            h = q.T @ (prec.a @ q)
            mu, z = torch.linalg.eigh(0.5 * (h + h.T))
            new, mu = q @ z[:, :b], mu[:b]
            mx = m_t @ new
            # The step's part outside the last block (LOBPCG's P), M-orthogonal to it.
            step = new - x @ (x.T @ mx) if it else None
            x = new
            r = prec.a @ x - mx * mu
            w = prec.solve(r, INNER_RTOL, INNER_ITERS)
            # The residual in A's inverse norm (w ~ A^-1 r) over x's A norm, sqrt(mu): the
            # rounding of A x, all in its highest modes, weighs little there.
            worst = float(((r * w).sum(0).abs() / mu).sqrt()[:n_eig].max())
            lowest_pairs.last = {"iterations": it + 1, "residual": worst}
            if worst < tol or not bool(torch.isfinite(w).all()):
                break  # converged, or (float32) a factor too coarse to go on
        lam = (mu[:n_eig].double() + sigma).cpu().numpy()
        lam = np.concatenate([np.zeros(r6.shape[1]), lam])
        return lam, torch.cat([r6, x[:, :n_eig]], 1).double().cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def solve_modes(points, tets, material, excite, num_modes, num_fem_modes, min_freq,
                max_freq, dtype=np.float64):
    """fem.solve_modes's answer ({"freqs", "t60s", "shapes" (P, K, 3), "dofs",
    "eigenvalues"}) with the pairs from lowest_pairs above."""
    points = np.asarray(points, np.float64)
    kept = fem.keep_elements(points, tets)
    nodes, n_nodes = fem.quadratic_nodes(kept, points.shape[0])
    k, m = [], []
    for lo in range(0, len(kept), 8192):  # the element arrays a chunk at a time
        ke, me = fem.element_matrices(points, kept[lo:lo + 8192], material["density"],
                                      material["young"], material["poisson"], dtype)
        k.append(ke)
        m.append(me)
    kk, mm, touched = fem.assemble(nodes, np.concatenate(k), np.concatenate(m), n_nodes)
    del k, m
    p = prolongation(kept, points.shape[0], touched)
    rigid = rigid_motions(points, kept, nodes, n_nodes, touched)
    n_eig = min(num_fem_modes, kk.shape[0] - 1)
    vals, vecs = lowest_pairs(kk, mm, p, rigid, n_eig, -((2 * np.pi * min_freq) ** 2), dtype)
    where = {int(d): i for i, d in enumerate(touched)}
    ex = fem.nearest_vertices(points, excite)
    rows = np.array([[where[3 * v + c] for c in range(3)] for v in ex])  # (P, 3)
    shapes = vecs[rows].transpose(0, 2, 1)  # (P, n_eig, 3)
    freqs, t60s, shapes = fem.postprocess(vals, shapes, material, num_modes, min_freq,
                                          max_freq)
    return {"freqs": freqs, "t60s": t60s, "shapes": shapes, "dofs": 3 * n_nodes,
            "eigenvalues": vals}
