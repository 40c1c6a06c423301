"""FEM assembly for isotropic linear elasticity over quadratic (10-node) tets, in element
form on the device (counterpart of mesheditor_tpu/fem/assembly.py).

The pencil (K, M) is never assembled into sparse matrices: it stays as

- a dense (E, 30, 30) float64 array of per-element stiffness blocks, and
- the element masses rho*V[e] times one shared (30, 30) unit block kron(mass_tab, I3).

Applying an operator to an (n, p) panel is index_select -> batched 30x30 matmul (bmm) ->
index_add_, at NODE granularity: the dof layout is (node, component)-major, so each node's
(3, p) slab is one contiguous row of x.reshape(n_nodes, 3p).

Everything is float64. The reference's TPU-forced variants (f32/bf16 block copies, the
split-K apply, macro-element clustering) answer nothing Hopper needs: it has native f64.

Reproducibility: index_add_ on a CUDA tensor accumulates with atomics, so the order of the
per-dof sums (and their last bits, ~1e-16 relative) differs from run to run. Nothing in the
solve depends on bit-reproducibility; results are compared by tolerance.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..types import AcousticMaterialProperties
from .quad_basis import quad_basis
from .quad_mesh import QuadMesh


def filter_degenerate(points: np.ndarray, tets: np.ndarray) -> np.ndarray:
    """Drop degenerate elements whose inverse-determinant basis gradients would poison the
    stiffness matrix (reference: src/audio/mesh2modes.cpp:42-60). Returns the kept tets."""
    points = np.asarray(points, dtype=np.float64)
    tets = np.asarray(tets, dtype=np.int64)
    v = points[tets]  # (E, 4, 3)
    r = v[:, 1:] - v[:, :1]  # (E, 3, 3)
    det = np.abs(np.einsum("ei,ei->e", r[:, 0], np.cross(r[:, 1], r[:, 2])))
    # Longest edge (squared) across all 6 vertex pairs.
    lmax_sq = np.zeros(tets.shape[0])
    for i in range(4):
        for j in range(i + 1, 4):
            d = v[:, i] - v[:, j]
            lmax_sq = np.maximum(lmax_sq, np.einsum("ei,ei->e", d, d))
    keep = det > 1e-12 * lmax_sq * np.sqrt(lmax_sq)
    return tets[keep].astype(np.uint32)


def _apply_node(elem_nodes: torch.Tensor, blocks: torch.Tensor, x: torch.Tensor,
                n_dofs: int) -> torch.Tensor:
    """y = A @ x for (E, 30, 30) element blocks, or for ONE (30, 30) block scaled per
    element when `blocks` is a (scale (E,), unit (30, 30)) pair (the mass form)."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    p = x.shape[1]
    n_nodes = n_dofs // 3
    e = elem_nodes.shape[0]
    flat = elem_nodes.reshape(-1)
    xe = x.reshape(n_nodes, 3 * p).index_select(0, flat).reshape(e, 30, p)
    if isinstance(blocks, tuple):
        scale, unit = blocks
        ye = torch.matmul(unit, xe) * scale[:, None, None]
    else:
        ye = torch.bmm(blocks, xe)
    y = torch.zeros(n_nodes, 3 * p, dtype=x.dtype, device=x.device)
    y.index_add_(0, flat, ye.reshape(e * 10, 3 * p))
    y = y.reshape(n_dofs, p)
    return y[:, 0] if squeeze else y


def _add_fix(y: torch.Tensor, x: torch.Tensor, fix: torch.Tensor) -> torch.Tensor:
    return y + (fix[:, None] * x if x.dim() > 1 else fix * x)


@dataclass(frozen=True)
class ElementOperators:
    """Matrix-free pencil (K, M) in element form, float64 on one device.

    elem_nodes: (E, 10) int64 quadratic-node ids; element dof 3*a+c is node a, component c
    k_blocks:   (E, 30, 30) per-element stiffness
    rho_vol:    (E,) density * element volume
    m_unit:     (30, 30) kron(mass_tab, I3), shared by every element
    k_fix/m_fix: (n_dofs,) diagonal parking for dofs no element touches (see _orphan_fixes)
    """

    elem_nodes: torch.Tensor
    k_blocks: torch.Tensor
    rho_vol: torch.Tensor
    m_unit: torch.Tensor
    k_fix: torch.Tensor
    m_fix: torch.Tensor
    n_dofs: int

    @property
    def device(self) -> torch.device:
        return self.k_blocks.device

    @property
    def elem_dofs(self) -> torch.Tensor:
        """(E, 30) global dof of each element-local dof."""
        comp = torch.arange(3, device=self.elem_nodes.device)
        return (3 * self.elem_nodes[:, :, None] + comp).reshape(-1, 30)

    def kmat(self, x: torch.Tensor) -> torch.Tensor:
        return _add_fix(_apply_node(self.elem_nodes, self.k_blocks, x, self.n_dofs), x, self.k_fix)

    def mmat(self, x: torch.Tensor) -> torch.Tensor:
        y = _apply_node(self.elem_nodes, (self.rho_vol, self.m_unit), x, self.n_dofs)
        return _add_fix(y, x, self.m_fix)

    def shifted(self, sigma: float) -> "ShiftedElementOperator":
        """A = K - sigma*M baked into one block array (the role of the reference's
        bake_shifted_f32, in float64 and element form only)."""
        a = self.k_blocks - sigma * (self.rho_vol[:, None, None] * self.m_unit[None])
        return ShiftedElementOperator(self.elem_nodes, a, self.k_fix - sigma * self.m_fix,
                                      self.n_dofs)


@dataclass(frozen=True)
class ShiftedElementOperator:
    """A = K - sigma*M as (E, 30, 30) float64 blocks: the inner solve's operator."""

    elem_nodes: torch.Tensor
    a_blocks: torch.Tensor
    a_fix: torch.Tensor
    n_dofs: int

    def amat(self, x: torch.Tensor) -> torch.Tensor:
        return _add_fix(_apply_node(self.elem_nodes, self.a_blocks, x, self.n_dofs), x, self.a_fix)


def _build_k_blocks_host(points, tets, grad_tab, lam, mu):
    """Per-element stiffness blocks (E, 30, 30) and volumes, numpy float64.

    K[(a,p),(c,q)] = V * (lambda * G[p,q] + mu * G[q,p] + delta_pq * mu * tr(G)) with
    G[p,q] = sum_{k,l} grad_tab[a,k,c,l] * Phig[k,p] * Phig[l,q] (reference assembly,
    src/audio/mesh2modes.cpp:128-327)."""
    v = points[tets]
    d1, d2, d3 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], v[:, 3] - v[:, 0]
    det = np.einsum("ei,ei->e", d1, np.cross(d2, d3))
    inv_det = 1.0 / det
    g1 = np.cross(d2, d3) * inv_det[:, None]
    g2 = np.cross(d3, d1) * inv_det[:, None]
    g3 = np.cross(d1, d2) * inv_det[:, None]
    phig = np.stack([-(g1 + g2 + g3), g1, g2, g3], axis=1)
    volume = np.abs(det) / 6.0
    g = np.einsum("akcl,ekp,elq->eacpq", grad_tab, phig, phig, optimize=True)
    tr = np.einsum("eacpp->eac", g)
    eye3 = np.eye(3)
    k = lam * g + mu * np.swapaxes(g, -1, -2) + mu * tr[..., None, None] * eye3
    k *= volume[:, None, None, None, None]
    k = np.transpose(k, (0, 1, 3, 2, 4)).reshape(-1, 30, 30)
    return k, volume


def _scatter_diag(elem_nodes, diag_e, n_dofs):
    """(E, 30) element diagonals -> (n_dofs,) assembled diagonal."""
    e = elem_nodes.shape[0]
    y = torch.zeros(n_dofs // 3, 3, dtype=diag_e.dtype, device=diag_e.device)
    y.index_add_(0, elem_nodes.reshape(-1), diag_e.reshape(e * 10, 3))
    return y.reshape(-1)


def _orphan_fixes(k_blocks, rho_vol, m_unit, elem_nodes, n_dofs: int):
    """Diagonal parking for dofs no element touches (orphan/padding vertices): a stiffness
    over a mass at ~100x the pencil's own lambda_max keeps their eigenvalues far above any
    audible window instead of leaving a singular 0/0 pencil block."""
    k_diag = _scatter_diag(elem_nodes, torch.diagonal(k_blocks, dim1=1, dim2=2), n_dofs)
    m_diag = _scatter_diag(elem_nodes, rho_vol[:, None] * torch.diagonal(m_unit)[None, :],
                           n_dofs)
    ones = torch.ones(elem_nodes.numel(), 3, dtype=k_diag.dtype, device=k_diag.device)
    touched = torch.zeros(n_dofs // 3, 3, dtype=k_diag.dtype, device=k_diag.device)
    touched.index_add_(0, elem_nodes.reshape(-1), ones)
    touched = touched.reshape(-1) > 0
    live = touched & (m_diag > 0)
    if bool(live.any()):
        lam_est = torch.max(k_diag[live] / m_diag[live])
        m_scale = torch.quantile(m_diag[live], 0.5)  # numpy's median (mean of the middle two)
    else:
        lam_est = m_scale = torch.ones((), dtype=k_diag.dtype, device=k_diag.device)
    zero = torch.zeros_like(k_diag)
    k_fix = torch.where(touched, zero, 100.0 * lam_est * m_scale)
    m_fix = torch.where(touched, zero, m_scale.expand_as(zero))
    return k_fix, m_fix


def assemble_element_matrices(
    points: np.ndarray,
    tets: np.ndarray,
    material: AcousticMaterialProperties,
    quad: QuadMesh,
    device="cpu",
) -> ElementOperators:
    """Build the element-form pencil operators for a (filtered) tet mesh on `device`.
    The element blocks are formed on the host in numpy (one vectorized pass) and uploaded."""
    device = torch.device(device)
    mass_tab, grad_tab = quad_basis()
    n_dofs = 3 * quad.node_count
    k_blocks, volume = _build_k_blocks_host(
        np.asarray(points, dtype=np.float64), np.asarray(tets, dtype=np.int64), grad_tab,
        material.lame_lambda(), material.lame_mu(),
    )
    f64 = dict(dtype=torch.float64, device=device)
    k_blocks = torch.as_tensor(k_blocks, **f64)
    rho_vol = torch.as_tensor(material.density * volume, **f64)
    m_unit = torch.as_tensor(np.kron(mass_tab, np.eye(3)), **f64)
    nodes = torch.as_tensor(quad.element_nodes.astype(np.int64), device=device)
    k_fix, m_fix = _orphan_fixes(k_blocks, rho_vol, m_unit, nodes, n_dofs)
    return ElementOperators(nodes, k_blocks, rho_vol, m_unit, k_fix, m_fix, n_dofs)


def pencil_diagonals(ops: ElementOperators):
    """diag(K) and diag(M), scattered from the element blocks (Jacobi preconditioning)."""
    k_diag = _scatter_diag(ops.elem_nodes, torch.diagonal(ops.k_blocks, dim1=1, dim2=2),
                           ops.n_dofs)
    m_diag = _scatter_diag(ops.elem_nodes,
                           ops.rho_vol[:, None] * torch.diagonal(ops.m_unit)[None, :],
                           ops.n_dofs)
    return k_diag + ops.k_fix, m_diag + ops.m_fix
