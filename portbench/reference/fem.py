"""Plain NumPy/SciPy reference of the modal solve: quadratic (10-node) tetrahedral
elements for isotropic linear elasticity, assembled into sparse K and M, the lowest
eigenpairs by shift-invert block Krylov with Rayleigh-Ritz (plain PyTorch: a dense
LU factor of K - sigma M, on the card when there is one), and the post-processing into damped
frequencies, T60s and mass-normalised shapes at the excitation points.

Written from the textbook element, not from the program: the element integrals come from
a collapsed-cube (Duffy) Gauss-Legendre rule of 4^3 points, exact for the degree-4
products of the quadratic shape functions. The semantics it follows are those the program
states: the degenerate-element rule, the eigensolver shift -(2 pi f_min)^2, excitation
positions snapped to the nearest input vertex, Rayleigh damping c = alpha + beta omega^2,
omega_d = sqrt(omega^2 - c^2/4), T60 = 2 ln(1000) / c, and the audible-band selection.

`dtype` is float64 for the reference and float32 for its lower-precision control: the
elements, the assembly, the factorisation and the iteration all run in it (TF32 off).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# Local edge nodes 4..9 sit at the midpoints of these corner pairs.
EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _tet_rule(n: int = 4):
    """Barycentric points (Q, 4) and weights (Q,) of a rule on the unit tetrahedron
    (weights sum to its volume 1/6): Gauss-Legendre on the cube, collapsed."""
    g, w = np.polynomial.legendre.leggauss(n)
    g, w = 0.5 * (g + 1.0), 0.5 * w
    u, v, t = np.meshgrid(g, g, g, indexing="ij")
    wu, wv, wt = np.meshgrid(w, w, w, indexing="ij")
    x = u
    y = v * (1.0 - u)
    z = t * (1.0 - u) * (1.0 - v)
    weight = wu * wv * wt * (1.0 - u) ** 2 * (1.0 - v)
    pts = np.stack([x.ravel(), y.ravel(), z.ravel()], 1)
    bary = np.concatenate([1.0 - pts.sum(1, keepdims=True), pts], 1)
    return bary, weight.ravel()


def _shape(bary):
    """Shape functions (Q, 10) and their barycentric derivatives (Q, 10, 4)."""
    q = bary.shape[0]
    n = np.zeros((q, 10))
    dn = np.zeros((q, 10, 4))
    for a in range(4):
        n[:, a] = bary[:, a] * (2.0 * bary[:, a] - 1.0)
        dn[:, a, a] = 4.0 * bary[:, a] - 1.0
    for e, (i, j) in enumerate(EDGES):
        n[:, 4 + e] = 4.0 * bary[:, i] * bary[:, j]
        dn[:, 4 + e, i] = 4.0 * bary[:, j]
        dn[:, 4 + e, j] = 4.0 * bary[:, i]
    return n, dn


def keep_elements(points, tets):
    """The elements the program keeps: volume above 1e-12 of the longest edge cubed."""
    v = np.asarray(points, np.float64)[np.asarray(tets, np.int64)]
    r = v[:, 1:] - v[:, :1]
    vol6 = np.abs(np.einsum("ei,ei->e", r[:, 0], np.cross(r[:, 1], r[:, 2])))
    lmax = np.zeros(len(v))
    for i in range(4):
        for j in range(i + 1, 4):
            lmax = np.maximum(lmax, ((v[:, i] - v[:, j]) ** 2).sum(1))
    return np.asarray(tets, np.int64)[vol6 > 1e-12 * lmax ** 1.5]


def quadratic_nodes(tets, n_vertices: int):
    """(E, 10) node ids: the corners keep their vertex ids, each edge's midpoint gets one
    id after them."""
    pairs = np.stack([np.sort(tets[:, [i, j]], 1) for i, j in EDGES], 1)  # (E, 6, 2)
    key = pairs[..., 0] * np.int64(n_vertices) + pairs[..., 1]
    uniq, inv = np.unique(key.ravel(), return_inverse=True)
    nodes = np.concatenate([tets, n_vertices + inv.reshape(-1, 6)], 1)
    return nodes, n_vertices + len(uniq)


def element_matrices(points, tets, density, young, poisson, dtype=np.float64):
    """Element stiffness and mass (E, 30, 30), element dof 3*a + c."""
    lam = poisson * young / ((1 + poisson) * (1 - 2 * poisson))
    mu = young / (2 * (1 + poisson))
    x = np.asarray(points, np.float64)[tets].astype(dtype)  # (E, 4, 3)
    bary, w = _tet_rule()
    n, dn = (a.astype(dtype) for a in _shape(bary))
    w = w.astype(dtype)
    jac = np.stack([x[:, 1] - x[:, 0], x[:, 2] - x[:, 0], x[:, 3] - x[:, 0]], 1)  # rows
    vol6 = np.abs(np.linalg.det(jac))
    inv = np.linalg.inv(jac)  # grad of (l1, l2, l3) as columns
    gl = np.concatenate([-inv.sum(2, keepdims=True), inv], 2).transpose(0, 2, 1)  # (E, 4, 3)
    grads = np.einsum("qak,ekp->eqap", dn, gl)  # (E, Q, 10, 3)
    wv = w[None, :] * vol6[:, None]  # (E, Q)
    g = np.einsum("eq,eqap,eqcr->eacpr", wv, grads, grads)  # int dNa/dxp dNc/dxr
    tr = np.einsum("eacpp->eac", g)
    eye = np.eye(3, dtype=dtype)
    k = lam * g + mu * np.swapaxes(g, -1, -2) + mu * tr[..., None, None] * eye
    k = k.transpose(0, 1, 3, 2, 4).reshape(-1, 30, 30)
    mass = np.einsum("q,qa,qc->ac", w, n, n)  # per unit 6V
    m = (density * vol6)[:, None, None] * np.kron(mass, eye)[None]
    return k.astype(dtype), m.astype(dtype)


def assemble(nodes, k, m, n_nodes: int):
    """Sparse K and M over the dofs that some element touches; returns (K, M, dof ids)."""
    dofs = (3 * nodes[:, :, None] + np.arange(3)).reshape(-1, 30)
    rows = np.repeat(dofs, 30, axis=1).ravel()
    cols = np.tile(dofs, (1, 30)).ravel()
    n = 3 * n_nodes
    kk = sp.csr_matrix((k.ravel(), (rows, cols)), shape=(n, n))
    mm = sp.csr_matrix((m.ravel(), (rows, cols)), shape=(n, n))
    touched = np.unique(dofs)
    return kk[touched][:, touched], mm[touched][:, touched], touched


def postprocess(eigenvalues, shapes, material, num_modes, min_freq, max_freq):
    """Eigenvalues (ascending) and shapes (P, n_eig, 3) -> (freqs, t60s, shapes) of the
    audible band, lowest valid mode first."""
    lam = np.maximum(np.asarray(eigenvalues, np.float64), 0.0)
    omega = np.where(lam > (2 * np.pi * min_freq) ** 2 * 1e-10, np.sqrt(lam), 0.0)
    c = material["alpha"] + material["beta"] * omega ** 2
    wd2 = omega ** 2 - 0.25 * c ** 2
    freqs = np.where((omega > 0) & (wd2 > 0), np.sqrt(np.maximum(wd2, 0)) / (2 * np.pi), 0.0)
    valid = (omega > 0) & (freqs >= min_freq)
    if not valid.any():
        return np.zeros(0), np.zeros(0), np.zeros((shapes.shape[0], 0, 3))
    lo = int(np.argmax(valid))
    f, cc = freqs[lo:], c[lo:]
    hi = len(f)
    while hi > 0 and f[hi - 1] > max_freq:
        hi -= 1
    keep = min(num_modes, len(lam), hi)
    t60 = np.where(cc > 0, 2 * np.log(1000.0) / np.where(cc == 0, 1.0, cc), 0.0)
    return f[:keep], t60[:keep], shapes[:, lo:lo + keep, :]


def nearest_vertices(points, excite):
    """Each excitation position's nearest input vertex, deduplicated in request order."""
    d = ((np.asarray(excite, np.float64)[:, None, :] - points[None]) ** 2).sum(2)
    out = []
    for v in np.argmin(d, 1):
        if int(v) not in out:
            out.append(int(v))
    return np.asarray(out, np.int64)


def solve_modes(points, tets, material, excite, num_modes, num_fem_modes, min_freq,
                max_freq, dtype=np.float64):
    """The modal model of a tet mesh: {"freqs", "t60s", "shapes" (P, K, 3), "dofs",
    "eigenvalues"}. `material` is a dict with density, young, poisson, alpha, beta."""
    points = np.asarray(points, np.float64)
    kept = keep_elements(points, tets)
    nodes, n_nodes = quadratic_nodes(kept, points.shape[0])
    k, m = element_matrices(points, kept, material["density"], material["young"],
                            material["poisson"], dtype)
    kk, mm, touched = assemble(nodes, k, m, n_nodes)
    n_eig = min(num_fem_modes, kk.shape[0] - 1)
    vals, vecs = lowest_pairs(kk, mm, n_eig, -((2 * np.pi * min_freq) ** 2), dtype)
    where = {int(d): i for i, d in enumerate(touched)}
    ex = nearest_vertices(points, excite)
    rows = np.array([[where[3 * v + c] for c in range(3)] for v in ex])  # (P, 3)
    shapes = vecs[rows].transpose(0, 2, 1)  # (P, n_eig, 3)
    freqs, t60s, shapes = postprocess(vals.astype(np.float64), shapes.astype(np.float64),
                                      material, num_modes, min_freq, max_freq)
    return {"freqs": freqs, "t60s": t60s, "shapes": shapes, "dofs": 3 * n_nodes,
            "eigenvalues": vals.astype(np.float64)}



def _torch_sparse(a, dtype, device):
    import warnings

    import torch

    a = a.tocsr()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "sparse CSR support is in beta"
        return torch.sparse_csr_tensor(torch.as_tensor(a.indptr, dtype=torch.int64),
                                       torch.as_tensor(a.indices, dtype=torch.int64),
                                       torch.as_tensor(a.data), size=a.shape, dtype=dtype,
                                       check_invariants=False).to(device)


def lowest_pairs(kk, mm, n_eig: int, sigma: float, dtype, restarts: int = 12,
                 degree: int = 2, tol: float | None = None):
    """The n_eig lowest eigenpairs of K x = lam M x (ascending; vectors M-orthonormal):
    block Krylov on T = (K - sigma M)^-1 M from a seeded block of n_eig + guard columns,
    M-whitened, Rayleigh-Ritz on (K, M), restarted from the Ritz vectors until no wanted
    value above the rigid floor moves by more than `tol` (relative) from one restart to
    the next. `lowest_pairs.last` records the restarts taken and the last change."""
    import torch

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    tdt = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    tol = tol if tol is not None else (1e-12 if tdt == torch.float64 else 1e-6)
    cut = 1e-13 if tdt == torch.float64 else 1e-6
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        n = kk.shape[0]
        a = (kk - sigma * mm).tocoo()
        dense = torch.zeros(n, n, dtype=tdt, device=dev)
        dense[torch.as_tensor(a.row, device=dev), torch.as_tensor(a.col, device=dev)] = \
            torch.as_tensor(a.data, dtype=tdt, device=dev)
        lu, piv = torch.linalg.lu_factor(dense)  # pivoted: rounding may leave it indefinite
        del dense
        k_t, m_t = _torch_sparse(kk, tdt, dev), _torch_sparse(mm, tdt, dev)
        b = min(n - 1, 2 * n_eig + 32)  # a guard as wide as the wanted block
        gen = torch.Generator(device=dev).manual_seed(20261017)
        x = torch.randn(n, b, generator=gen, dtype=tdt, device=dev)
        prev = None
        for restart in range(restarts):
            blocks = [x]
            for _j in range(degree):
                y = torch.linalg.lu_solve(lu, piv, m_t @ blocks[-1])
                blocks.append(y / y.norm(dim=0, keepdim=True))
            q = torch.cat(blocks, 1)
            g = q.T @ (m_t @ q)
            s, v = torch.linalg.eigh(0.5 * (g + g.T))
            keep = s > cut * s.max()
            q = q @ (v[:, keep] / s[keep].sqrt())
            h = q.T @ (k_t @ q)
            lam, z = torch.linalg.eigh(0.5 * (h + h.T))
            x = q @ z[:, :b]
            lam = lam[:b]
            # Converged when the wanted values above the rigid floor stop moving.
            top = lam[:n_eig].double()
            live = top > 1e-6 * top[-1]
            change = float(((top - prev).abs() / top)[live].max()) if prev is not None else 1.0
            prev = top
            lowest_pairs.last = {"restarts": restart + 1, "change": change}
            if change < tol:
                break
        return (lam[:n_eig].double().cpu().numpy(),
                x[:, :n_eig].double().cpu().numpy())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
