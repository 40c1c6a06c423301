"""Rigid-body-mode aggregation AMG preconditioner for the shifted pencil A = K - sigma*M
(counterpart of mesheditor_tpu/solve/amg.py), float64 on the device.

The eigensolver's inner solve approximates a sparse-Cholesky shift-invert with a few
steps of PCG. Jacobi alone is blind to A's near-kernel (the rigid-body motions, lifted only
by |sigma|*mass); a two-level aggregation multigrid whose coarse space holds every
aggregate's rigid-body modes supplies exactly those directions.

Host numpy builds the structure once per solve (aggregation over the element
co-occurrence graph, per-aggregate rigid-body QR, connected components); the device does
the Galerkin coarse pencil, the rigid basis, the coarse inverse and every application.

Differences from the reference, all because Hopper has native f64:
- every stage runs in float64; the coarse inverse is a plain torch.linalg.inv of the
  (nc, nc) lifted operator (the reference's host-CPU branch) instead of the Newton-Schulz
  climb, and the inverse stays float64;
- the Jacobi radius for the smoother damping uses the exact element-form shifted operator.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fem.assembly import NodeSum
from ..profile import scope


def _restrict(w: torch.Tensor, agg: torch.Tensor, nagg: int, x: torch.Tensor) -> torch.Tensor:
    """P^T x: coarse coordinates of an (n_dofs, p) panel, one (6p)-wide row per node.

    Each aggregate's rows are summed in node order by a segmented sum, so equal inputs give
    equal bits on every run and every rank (index_add_ on the card adds in no fixed order).
    The element-sharded solve needs that: its replicated panels must stay bit-equal across
    ranks, or the ranks' partial applies would act on different panels."""
    nn = w.shape[0]
    p = x.shape[1]
    xn = torch.einsum("nck,ncp->nkp", w, x.reshape(nn, 3, p)).reshape(nn, 6 * p)
    return NodeSum.of(agg, nagg)(xn).reshape(nagg * 6, p)


def _prolong(w: torch.Tensor, agg: torch.Tensor, nagg: int, xc: torch.Tensor) -> torch.Tensor:
    """P xc: the fine (n_dofs, p) panel of an (nc, p) coarse panel."""
    nn = w.shape[0]
    p = xc.shape[1]
    xn = xc.reshape(nagg, 6 * p).index_select(0, agg).reshape(nn, 6, p)
    return torch.einsum("nck,nkp->ncp", w, xn).reshape(-1, p)


@dataclass(frozen=True)
class AmgPrecond:
    """Two-level additive aggregation-AMG cycle for the shifted pencil (all float64).

    agg: (n_nodes,) int64 aggregate of each node (orphans clipped to 0; their w rows are 0)
    w: (n_nodes, 3, 6) node blocks of the rigid-body prolongator, orthonormal per aggregate
    ac_inv: (nc, nc) inverse of the rigid-lifted coarse operator, nc = 6*nagg
    inv_diag: (n_dofs,) Jacobi of the shifted pencil
    rigid, m_rigid: (n_dofs, 6*ncomp) M-orthonormal global rigid modes and M @ rigid
    mc: (nc, nc) coarse mass P^T M P (closes the coarse pencil for spectral_seed)
    sa: smoothed-aggregation transfer damping (0 = plain aggregation)
    """

    agg: torch.Tensor
    w: torch.Tensor
    ac_inv: torch.Tensor
    inv_diag: torch.Tensor
    rigid: torch.Tensor
    m_rigid: torch.Tensor
    mc: torch.Tensor
    omega: float
    nagg: int
    sa: float = 0.0

    def restrict(self, x: torch.Tensor) -> torch.Tensor:
        return _restrict(self.w, self.agg, self.nagg, x)

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        return _prolong(self.w, self.agg, self.nagg, xc)

    def deflate(self, x: torch.Tensor) -> torch.Tensor:
        """x - R (M R)^T x: remove the M-projection onto the rigid modes."""
        return x - self.rigid @ (self.m_rigid.T @ x)

    def _coarse_correct(self, r: torch.Tensor, apply_a=None) -> torch.Tensor:
        """Two-sided M-deflated coarse correction Pi P Ac^-1 P^T Pi^T r; with sa > 0 the
        transfers are smoothed on the fly, P_s = (I - sa D^-1 A) P."""
        rd = r - self.m_rigid @ (self.rigid.T @ r)
        if self.sa and apply_a is not None:
            rd = rd - self.sa * apply_a(self.inv_diag[:, None] * rd)
        e = self.prolong(self.ac_inv @ self.restrict(rd))
        if self.sa and apply_a is not None:
            e = e - self.sa * (self.inv_diag[:, None] * apply_a(e))
        return self.deflate(e)

    def apply(self, apply_a, r: torch.Tensor) -> torch.Tensor:
        """z = omega D^-1 r + coarse(r): the additive (BPX) two-level cycle (the
        `solve/eigs/amg` span)."""
        with scope("solve/eigs/amg"):
            return (self.omega * self.inv_diag[:, None] * r
                    + self._coarse_correct(r, apply_a if self.sa else None))


def _components(element_nodes: np.ndarray, n_nodes: int):
    """Connected components of the element-node graph (scipy union-find). Disconnected
    meshes carry 6 rigid modes PER component; deflation and seeding must cover all."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    en = np.asarray(element_nodes, np.int64)
    rows = en[:, :-1].reshape(-1)
    cols = en[:, 1:].reshape(-1)
    g = sp.coo_matrix(
        (np.ones(rows.size, np.int8), (rows, cols)), shape=(n_nodes, n_nodes)
    )
    _, labels = connected_components(g, directed=False)
    labels = labels.copy()
    touched = np.zeros(n_nodes, bool)
    touched[en.reshape(-1)] = True
    # Re-label so only element-touched components count; orphans get -1.
    live = np.unique(labels[touched])
    remap = np.full(labels.max() + 1, -1, np.int64)
    remap[live] = np.arange(live.size)
    labels = np.where(touched, remap[labels], -1)
    return labels, live.size


def rigid_modes(coords: np.ndarray, comp: np.ndarray, ncomp: int, n_dofs: int):
    """Per-component rigid-body modes as (n_dofs, 6*ncomp) float64, un-normalized
    (callers M-orthonormalize against the actual mass matrix)."""
    r = np.zeros((n_dofs, 6 * ncomp))
    for c in range(ncomp):
        idx = np.where(comp == c)[0]
        if idx.size == 0:
            continue
        x = coords[idx]
        ctr = x.mean(axis=0)
        d = x - ctr
        scale = max(float(np.abs(d).max()), 1e-30)
        ds = d / scale
        base = 6 * c
        rows = 3 * idx
        r[rows + 0, base + 0] = 1.0
        r[rows + 1, base + 1] = 1.0
        r[rows + 2, base + 2] = 1.0
        r[rows + 1, base + 3], r[rows + 2, base + 3] = -ds[:, 2], ds[:, 1]
        r[rows + 0, base + 4], r[rows + 2, base + 4] = ds[:, 2], -ds[:, 0]
        r[rows + 0, base + 5], r[rows + 1, base + 5] = -ds[:, 1], ds[:, 0]
    return r


def _quad_node_coords(points: np.ndarray, kept_tets: np.ndarray, n_nodes: int):
    """Coordinates for all quadratic nodes: corners then mid-edge midpoints, in the
    exact id order build_quad_mesh assigns (same unique-key recomputation,
    fem/quad_mesh.py:26-39)."""
    from ..fem.quad_basis import EDGE_CORNERS

    points = np.asarray(points, np.float64)
    tets = np.asarray(kept_tets, np.int64)
    ec = np.asarray(EDGE_CORNERS, np.int64)
    a = tets[:, ec[:, 0]]
    b = tets[:, ec[:, 1]]
    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    keys = np.unique(((lo << np.int64(32)) | hi).reshape(-1))
    coords = np.zeros((n_nodes, 3))
    npts = points.shape[0]
    coords[:npts] = points
    e_lo = (keys >> np.int64(32)).astype(np.int64)
    e_hi = (keys & np.int64(0xFFFFFFFF)).astype(np.int64)
    coords[npts : npts + keys.size] = 0.5 * (points[e_lo] + points[e_hi])
    return coords


def _aggregate(element_nodes: np.ndarray, n_nodes: int, max_aggs: int):
    """Greedy distance-1 aggregation over the element co-occurrence node graph, with
    pairwise merge rounds until the aggregate count fits the coarse-dof budget.
    Deterministic (id order). Returns (agg ids (n_nodes,), nagg); orphan nodes -1."""
    en = np.asarray(element_nodes, np.int64)
    m = en.shape[0]
    # CSR node->elements.
    counts = np.bincount(en.reshape(-1), minlength=n_nodes)
    eptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=eptr[1:])
    order = np.argsort(en.reshape(-1), kind="stable")
    eids = order // 10  # element of each sorted node slot
    agg = np.full(n_nodes, -1, np.int64)
    touched = counts > 0
    nagg = 0
    for v in range(n_nodes):
        if agg[v] != -1 or not touched[v]:
            continue
        neigh = en[eids[eptr[v] : eptr[v + 1]]].reshape(-1)
        members = neigh[agg[neigh] == -1]
        agg[members] = nagg
        agg[v] = nagg
        nagg += 1
    # Attach any stragglers (can't occur with distance-1 sweeps, but keep it safe).
    for v in range(n_nodes):
        if agg[v] == -1 and touched[v]:
            neigh = en[eids[eptr[v] : eptr[v + 1]]].reshape(-1)
            owned = agg[neigh]
            owned = owned[owned >= 0]
            agg[v] = owned[0] if owned.size else 0
    # Merge rounds: halve the aggregate count by merging each aggregate into a
    # neighboring one (union over member nodes' element neighborhoods).
    while nagg > max_aggs:
        merge_to = np.full(nagg, -1, np.int64)
        taken = np.zeros(nagg, bool)
        # Aggregate adjacency via element membership: for each element, its nodes'
        # aggregates are mutually adjacent; pair each aggregate with the first
        # un-taken neighbor encountered.
        ea = agg[en]  # (m, 10)
        for e in range(m):
            row = ea[e]
            base = row[0]
            for k in range(1, 10):
                a2, b2 = row[k - 1], row[k]
                if a2 != b2:
                    lo2, hi2 = (a2, b2) if a2 < b2 else (b2, a2)
                    if merge_to[hi2] == -1 and not taken[lo2] and not taken[hi2] and lo2 != hi2:
                        merge_to[hi2] = lo2
                        taken[lo2] = taken[hi2] = True
            _ = base
        relabel = np.arange(nagg)
        src = np.where(merge_to >= 0)[0]
        relabel[src] = merge_to[src]
        # Compress ids.
        uniq, inv = np.unique(relabel, return_inverse=True)
        agg = np.where(agg >= 0, inv[np.clip(agg, 0, None)], -1)
        if uniq.size == nagg:  # no merges possible; accept the size
            break
        nagg = uniq.size
    return agg, nagg


def _rigid_weights(coords: np.ndarray, agg: np.ndarray, nagg: int):
    """Per-node (3,6) blocks of the aggregate-wise rigid-body prolongator, orthonormal
    per aggregate (QR of [translations | rotations-about-centroid])."""
    n_nodes = coords.shape[0]
    w = np.zeros((n_nodes, 3, 6), np.float64)
    for a in range(nagg):
        idx = np.where(agg == a)[0]
        if idx.size == 0:
            continue
        x = coords[idx]
        c = x.mean(axis=0)
        d = x - c
        scale = max(float(np.abs(d).max()), 1e-30)
        k = idx.size
        b = np.zeros((3 * k, 6))
        b[0::3, 0] = b[1::3, 1] = b[2::3, 2] = 1.0
        # Rotation columns e_j x (x - c), scaled to O(1) for QR conditioning.
        ds = d / scale
        b[1::3, 3], b[2::3, 3] = -ds[:, 2], ds[:, 1]
        b[0::3, 4], b[2::3, 4] = ds[:, 2], -ds[:, 0]
        b[0::3, 5], b[1::3, 5] = -ds[:, 1], ds[:, 0]
        q, r = np.linalg.qr(b)
        # Degenerate aggregates (single node, collinear nodes) leave trailing R diag
        # ~0; those q columns are arbitrary-but-orthonormal, harmless under the
        # coarse-diag regularization in build_amg.
        cols = min(6, q.shape[1])
        w[idx, :, :cols] = q[:, :cols].reshape(k, 3, cols)
    return w


def _add_in_order(acc: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor) -> None:
    """acc[ids[k]] += rows[k] for k ascending, as a segmented sum in which each target's old
    value leads its segment: index_add_'s order on the CPU, and a fixed one on the card,
    where index_add_ adds with atomics in no fixed order."""
    uniq, counts = torch.unique(ids, return_counts=True)
    order = torch.argsort(torch.cat([uniq, ids]), stable=True)
    vals = torch.cat([acc.index_select(0, uniq), rows]).index_select(0, order)
    acc[uniq] = torch.segment_reduce(vals, "sum", lengths=counts + 1, axis=0, unsafe=True)


# Elements per coarse-assembly chunk: bounds the (2, chunk, 60, 60) f64 temporary.
_AC_CHUNK = 2048


def _coarse_assemble_pencil(ops, w: torch.Tensor, agg: torch.Tensor, nagg: int):
    """Galerkin coarse pencil (Kc, Mc) = (P^T K P, P^T M P), float64 on the device (summed
    over a tensor-parallel group when `ops` holds one slice of the elements).

    Per element, P_e is block-diagonal over its 10 nodes (node i's (3, 6) block w[node_i]
    in rows 3i.., columns 6i..), so P_e^T B_e P_e is a (10, 10) grid of 6x6 blocks; block
    (i, j) is added at aggregate pair (agg[node_i], agg[node_j]), in (element, i, j) order
    (_add_in_order), so the pencil has the same bits on every run."""
    en = ops.elem_nodes
    e_total = en.shape[0]
    dev = w.device
    acc = torch.zeros(nagg * nagg, 2 * 36, dtype=torch.float64, device=dev)
    eye10 = torch.eye(10, dtype=torch.float64, device=dev)
    for s in range(0, e_total, _AC_CHUNK):
        en_c = en[s : s + _AC_CHUNK]
        ch = en_c.shape[0]
        wn = w.index_select(0, en_c.reshape(-1)).reshape(ch, 10, 3, 6)
        # Block-diagonal P_e: (ch, 10, 3, 10, 6) -> (ch, 30, 60).
        pe = (wn[:, :, :, None, :] * eye10[None, :, None, :, None]).reshape(ch, 30, 60)
        kb = ops.k_blocks[s : s + ch]
        mb = ops.rho_vol[s : s + ch, None, None] * ops.m_unit[None]
        bl = torch.stack([kb, mb])  # (2, ch, 30, 30)
        t = pe.transpose(1, 2)[None] @ (bl @ pe[None])  # (2, ch, 60, 60)
        t = t.reshape(2, ch, 10, 6, 10, 6).permute(1, 2, 4, 0, 3, 5)  # (ch, 10, 10, 2, 6, 6)
        ag = agg.index_select(0, en_c.reshape(-1)).reshape(ch, 10)
        ids = (ag[:, :, None] * nagg + ag[:, None, :]).reshape(-1)
        _add_in_order(acc, ids, t.reshape(ch * 100, 72))
    if ops.tp is not None:  # this rank's elements only: sum the group's partials
        acc = ops.tp.sum(acc)
    acc = acc.reshape(nagg, nagg, 2, 6, 6).permute(2, 0, 3, 1, 4).reshape(2, 6 * nagg, 6 * nagg)
    return acc[0], acc[1]


def _rigid_modes_device(coords: torch.Tensor, comp: torch.Tensor, ncomp: int) -> torch.Tensor:
    """Per-component rigid-body modes on the device as (n_dofs, 6*ncomp) float64, the same
    columns as rigid_modes(); orphan nodes (comp < 0) get zero rows."""
    nn = coords.shape[0]
    z = torch.zeros(nn, dtype=coords.dtype, device=coords.device)
    cols = []
    for c in range(ncomp):
        m = (comp == c).to(coords.dtype)
        cnt = torch.clamp(m.sum(), min=1.0)
        ctr = (coords * m[:, None]).sum(0) / cnt
        d = (coords - ctr) * m[:, None]
        scale = torch.clamp(d.abs().max(), min=1e-30)
        ds = d / scale
        cols += [
            torch.stack([m, z, z], 1), torch.stack([z, m, z], 1), torch.stack([z, z, m], 1),
            torch.stack([z, -ds[:, 2], ds[:, 1]], 1),
            torch.stack([ds[:, 2], z, -ds[:, 0]], 1),
            torch.stack([-ds[:, 1], ds[:, 0], z], 1),
        ]
    # (nn, 3, 6c) -> (3*nn, 6c): rows are dof-ordered (3*node + axis).
    return torch.stack(cols, 2).reshape(nn * 3, 6 * ncomp)


def _inv_chol_t(g: torch.Tensor, ridge: float) -> torch.Tensor:
    """L^-T for the Cholesky factor L of g + ridge*tr(g)/k*I, so v @ L^-T whitens v."""
    k = g.shape[0]
    g = 0.5 * (g + g.T)
    g = g + ridge * torch.trace(g) / k * torch.eye(k, dtype=g.dtype, device=g.device)
    ell = torch.linalg.cholesky(g)
    eye = torch.eye(k, dtype=g.dtype, device=g.device)
    return torch.linalg.solve_triangular(ell, eye, upper=False).T


def _lift_rigid(ac: torch.Tensor, vc: torch.Tensor) -> torch.Tensor:
    """Ac + tau * Q Q^T along the coarse coordinates vc = P^T R of the global rigid modes
    (Q an orthonormal basis of span(vc), tau = 1e-3 * max diag). The rigid span is
    M-deflated at the fine level anyway, so answering 1/tau there costs nothing, and the
    lift keeps the rigid response (1/(|sigma|*mass)) out of every entry of the inverse."""
    q = vc @ _inv_chol_t(vc.T @ vc, 1e-12)
    tau = 1e-3 * torch.max(torch.diagonal(ac))
    return ac + tau * (q @ q.T)


def _coarse_inverse(ac: torch.Tensor) -> torch.Tensor:
    """Inverse of the lifted coarse operator: symmetrize, park dead coarse dofs (zero rows
    from degenerate aggregates; the threshold is MATRIX-relative) at the matrix scale,
    nudge live ones by 1e-12 relative, invert, symmetrize (PCG needs an exactly symmetric
    preconditioner)."""
    ac = 0.5 * (ac + ac.T)
    dg = torch.diagonal(ac)
    sc = torch.clamp(dg.max(), min=1e-300)
    ac = ac + torch.diag(torch.where(dg <= 1e-9 * sc, sc, 1e-12 * dg))
    inv = torch.linalg.inv(ac)
    return 0.5 * (inv + inv.T)


def _dinv_a_radius(amat, inv_diag: torch.Tensor, seed_dim: int, generator) -> float:
    """Spectral radius of D^-1 A by 12 steps of power iteration over a small panel: the
    Jacobi smoother is contractive only for omega < 2/rho, and rho(D^-1 K) routinely
    exceeds 2 for quadratic tets."""
    z = torch.randn(inv_diag.shape[0], seed_dim, dtype=torch.float64,
                    device=inv_diag.device, generator=generator)
    for _ in range(12):
        y = inv_diag[:, None] * amat(z)
        z = y / torch.clamp(torch.linalg.norm(y, dim=0, keepdim=True), min=1e-30)
    y = inv_diag[:, None] * amat(z)
    return float(torch.linalg.norm(y, dim=0).max())


def build_amg(
    points: np.ndarray,
    kept_tets: np.ndarray,
    quad,
    ops,
    k_diag: torch.Tensor,
    m_diag: torch.Tensor,
    sigma: float,
    *,
    max_coarse_dofs: int = 4096,
    omega: float = 0.0,
    sa="auto",
) -> AmgPrecond:
    """Build the two-level preconditioner for this solve's pencil on `ops.device`.

    On element-sharded `ops` every rank builds the whole preconditioner: the host structure
    from the whole mesh, the coarse pencil and the smoother's operator summed over the
    group, so the power iteration's radius (a host value) has the same bits on every rank.
    """
    dev = ops.device
    f64 = dict(dtype=torch.float64, device=dev)
    n_nodes = quad.node_count
    element_nodes = np.asarray(quad.element_nodes)
    coords = _quad_node_coords(points, kept_tets, n_nodes)
    agg, nagg = _aggregate(element_nodes, n_nodes, max_coarse_dofs // 6)
    w = _rigid_weights(coords, np.clip(agg, 0, None), nagg)
    w[agg < 0] = 0.0  # orphan nodes contribute nothing to the coarse space
    w_d = torch.as_tensor(w, **f64)
    agg_d = torch.as_tensor(np.clip(agg, 0, None), dtype=torch.int64, device=dev)
    kc, mc = _coarse_assemble_pencil(ops, w_d, agg_d, nagg)
    ac = kc - sigma * mc

    # Global per-component rigid modes, M-orthonormalized on the device.
    comp, ncomp = _components(element_nodes, n_nodes)
    r = _rigid_modes_device(torch.as_tensor(coords, **f64),
                            torch.as_tensor(comp, dtype=torch.int64, device=dev),
                            int(max(ncomp, 1)))
    mr = ops.mmat(r)
    linv_t = _inv_chol_t(r.T @ mr, 1e-14)
    rigid, m_rigid = r @ linv_t, mr @ linv_t

    ac_inv = _coarse_inverse(_lift_rigid(ac, _restrict(w_d, agg_d, nagg, rigid)))
    inv_diag = 1.0 / (k_diag - sigma * m_diag)

    if not omega:
        gen = torch.Generator(device=dev).manual_seed(7)  # the reference's PRNGKey(7)
        rho = _dinv_a_radius(ops.shifted(sigma).amat, inv_diag, 4, gen)
        omega = 1.0 / (1.05 * max(rho, 1.0))
    # Smoothed-aggregation transfer damping 4/(3 rho(D^-1 A)), ADAPTIVE on the element
    # volume spread: it pays only where element sizes are heterogeneous enough to starve
    # plain aggregation (conforming-Delaunay meshes, p90/p10 ~ 2+), and costs two extra
    # A-applies per coarse correction on structured grids (~1.0).
    if sa == "auto":
        vols = (ops.rho_vol if ops.tp is None else ops.tp.gather(ops.rho_vol)).cpu().numpy()
        live = vols[vols > 0]
        hetero = (float(np.percentile(live, 90)) / max(float(np.percentile(live, 10)), 1e-30)
                  if live.size else 1.0)
        sa_omega = (4.0 / 3.0) * float(omega) * 1.05 if hetero > 1.5 else 0.0
    else:
        sa_omega = float(sa)
    return AmgPrecond(agg_d, w_d, ac_inv, inv_diag, rigid, m_rigid, mc, float(omega),
                      int(nagg), sa_omega)


# ---- coarse spectral seeding ----
#
# The outer iteration count is set by how far the STARTING subspace is from the wanted
# eigenspace. The coarse pencil (Kc, Mc), already assembled for the cycle, approximates the
# lowest fine modes to coarse-grid accuracy; inverse subspace iteration on it with the
# already-inverted lifted operator hands the fine iteration a subspace converged that far.


def _mc_chol_qr(y: torch.Tensor, mc: torch.Tensor) -> torch.Tensor:
    """Two-pass Mc-orthonormalization (CholQR with column equilibration and a ridge)."""
    for _ in range(2):
        my = mc @ y
        d = torch.rsqrt(torch.clamp((y * my).sum(0), min=1e-300))
        y = y * d
        my = my * d
        y = y @ _inv_chol_t(y.T @ my, 1e-12)
    return y


def _coarse_inverse_subspace(ac_inv, mc, generator, q: int, iters: int, p_want: int):
    """Lowest-theta p_want approximate eigenvectors of the coarse pencil, Mc-orthonormal,
    by inverse subspace iteration with Ac_lifted^-1 and one final Rayleigh-Ritz."""
    nc = mc.shape[0]
    y = torch.randn(nc, q, dtype=torch.float64, device=mc.device, generator=generator)
    for _ in range(iters):
        y = _mc_chol_qr(ac_inv @ (mc @ y), mc)
    y = _mc_chol_qr(y, mc)
    # Reduced inverse operator t = Y^T Mc Ac^-1 Mc Y: its LARGEST eigenvalues are the
    # wanted (lowest-theta) modes.
    my = mc @ y
    t = my.T @ (ac_inv @ my)
    _mu, v = torch.linalg.eigh(0.5 * (t + t.T))
    return y @ v.flip(1)[:, :p_want]


def spectral_seed(amg: AmgPrecond, p: int, *, generator, guard: int = 128,
                  iters: int = 32):
    """(n_dofs, p) starting panel for the outer eigensolver: prolongated coarse Ritz
    vectors, rigid-deflated. None when the coarse space is too small to supply p useful
    columns (the caller falls back to a random start)."""
    nc = int(amg.mc.shape[0])
    if nc < 2 * p:
        return None
    q = int(min(nc, p + guard))
    yc = _coarse_inverse_subspace(amg.ac_inv, amg.mc, generator, q, iters, p)
    return amg.deflate(amg.prolong(yc))
