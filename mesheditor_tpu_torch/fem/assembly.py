"""FEM assembly for isotropic linear elasticity over quadratic (10-node) tets, in element
form on the device (counterpart of mesheditor_tpu/fem/assembly.py).

The pencil (K, M) is never assembled into sparse matrices: it stays as

- a dense (E, 30, 30) float64 array of per-element stiffness blocks, and
- the element masses rho*V[e] times one shared (30, 30) unit block kron(mass_tab, I3).

Applying an operator to an (n, p) panel is index_select -> batched 30x30 matmul (bmm) ->
ordered node sum, at NODE granularity: the dof layout is (node, component)-major, so each
node's (3, p) slab is one contiguous row of x.reshape(n_nodes, 3p).

Everything is float64. The reference's TPU-forced variants (f32/bf16 block copies, the
split-K apply, macro-element clustering) answer nothing Hopper needs: it has native f64.

Reproducibility: every element-to-node sum (the applies, the diagonals, the touched count)
adds each node's (element, local) slots in ascending order, by a segmented sum over a
node-sorted permutation built once per operator (NodeSum). index_add_ on a CUDA tensor adds
with atomics in no fixed order, so a solve repeated on the card would differ in its last
bits and, through them, in its modes' signs; with the fixed order it repeats bit for bit.
On the CPU index_add_ adds in slot order, so both forms give the same bits there.

Element sharding (parallel/sharding.py:shard_element_ops): an operator whose `tp` is set
holds one contiguous slice of the elements of a tensor-parallel group. Every element sum
(the applies, the diagonals) is then this rank's partial, summed over the group by one
all_reduce before the diagonal fixes are added, which every rank holds whole.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
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


@dataclass(frozen=True)
class NodeSum:
    """A row sum by group in a fixed order: the rows sorted by group, stable (each group's
    rows ascending), and each group's row count. For the element-to-node sums the rows are
    the (E*10,) element slots, in (element, local) order, and the groups the nodes."""

    order: torch.Tensor
    lengths: torch.Tensor

    @staticmethod
    def of(group: torch.Tensor, n_groups: int) -> "NodeSum":
        """The sum of rows into n_groups groups, row i into group[i] (any shape, flattened)."""
        flat = group.reshape(-1)
        return NodeSum(torch.argsort(flat, stable=True), torch.bincount(flat, minlength=n_groups))

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        """(rows, w) -> (n_groups, w) group sums, in the fixed order."""
        return torch.segment_reduce(rows.index_select(0, self.order), "sum",
                                    lengths=self.lengths, axis=0, unsafe=True)


def _apply_node(elem_nodes: torch.Tensor, blocks: torch.Tensor, x: torch.Tensor,
                n_dofs: int, slots: NodeSum) -> torch.Tensor:
    """y = A @ x for (E, 30, 30) element blocks, or for ONE (30, 30) block scaled per
    element when `blocks` is a (scale (E,), unit (30, 30)) pair (the mass form); the node
    sums in the order of `slots`."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    p = x.shape[1]
    n_nodes = n_dofs // 3
    e = elem_nodes.shape[0]
    xe = x.reshape(n_nodes, 3 * p).index_select(0, elem_nodes.reshape(-1)).reshape(e, 30, p)
    if isinstance(blocks, tuple):
        scale, unit = blocks
        ye = torch.matmul(unit, xe) * scale[:, None, None]
    else:
        ye = torch.bmm(blocks, xe)
    y = slots(ye.reshape(e * 10, 3 * p)).reshape(n_dofs, p)
    return y[:, 0] if squeeze else y


def _add_fix(y: torch.Tensor, x: torch.Tensor, fix: torch.Tensor) -> torch.Tensor:
    return y + (fix[:, None] * x if x.dim() > 1 else fix * x)


def _total(y: torch.Tensor, tp) -> torch.Tensor:
    """The element sum `y` over a tensor-parallel group (this rank's partial when `tp` is
    set; already whole when it is None)."""
    return y if tp is None else tp.sum(y)


@dataclass(frozen=True)
class ElementOperators:
    """Matrix-free pencil (K, M) in element form, float64 on one device.

    elem_nodes: (E, 10) int64 quadratic-node ids; element dof 3*a+c is node a, component c
    k_blocks:   (E, 30, 30) per-element stiffness
    rho_vol:    (E,) density * element volume
    m_unit:     (30, 30) kron(mass_tab, I3), shared by every element
    k_fix/m_fix: (n_dofs,) diagonal parking for dofs no element touches (see _orphan_fixes)
    tp: None, or this rank's ElementSlice of a tensor-parallel group (parallel/sharding.py):
        the element arrays are then the slice, k_fix/m_fix and n_dofs stay whole
    slots: the NodeSum of elem_nodes, built here when not given
    """

    elem_nodes: torch.Tensor
    k_blocks: torch.Tensor
    rho_vol: torch.Tensor
    m_unit: torch.Tensor
    k_fix: torch.Tensor
    m_fix: torch.Tensor
    n_dofs: int
    tp: object = None
    slots: NodeSum = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.slots is None:
            object.__setattr__(self, "slots", NodeSum.of(self.elem_nodes, self.n_dofs // 3))

    @property
    def device(self) -> torch.device:
        return self.k_blocks.device

    @property
    def elem_dofs(self) -> torch.Tensor:
        """(E, 30) global dof of each element-local dof."""
        comp = torch.arange(3, device=self.elem_nodes.device)
        return (3 * self.elem_nodes[:, :, None] + comp).reshape(-1, 30)

    def kmat(self, x: torch.Tensor) -> torch.Tensor:
        y = _apply_node(self.elem_nodes, self.k_blocks, x, self.n_dofs, self.slots)
        return _add_fix(_total(y, self.tp), x, self.k_fix)

    def mmat(self, x: torch.Tensor) -> torch.Tensor:
        y = _apply_node(self.elem_nodes, (self.rho_vol, self.m_unit), x, self.n_dofs,
                        self.slots)
        return _add_fix(_total(y, self.tp), x, self.m_fix)

    def shifted(self, sigma: float) -> "ShiftedElementOperator":
        """A = K - sigma*M baked into one block array (the role of the reference's
        bake_shifted_f32, in float64 and element form only)."""
        a = self.k_blocks - sigma * (self.rho_vol[:, None, None] * self.m_unit[None])
        return ShiftedElementOperator(self.elem_nodes, a, self.k_fix - sigma * self.m_fix,
                                      self.n_dofs, self.slots, self.tp)

    def whole(self) -> "ElementOperators":
        """Every element of the pencil on this rank: self when unsharded, else the group's
        slices gathered (an exact zero-padded sum)."""
        if self.tp is None:
            return self
        return ElementOperators(self.tp.gather(self.elem_nodes), self.tp.gather(self.k_blocks),
                                self.tp.gather(self.rho_vol), self.m_unit, self.k_fix,
                                self.m_fix, self.n_dofs)


@dataclass(frozen=True)
class ShiftedElementOperator:
    """A = K - sigma*M as (E, 30, 30) float64 blocks: the inner solve's operator."""

    elem_nodes: torch.Tensor
    a_blocks: torch.Tensor
    a_fix: torch.Tensor
    n_dofs: int
    slots: NodeSum
    tp: object = None

    def amat(self, x: torch.Tensor) -> torch.Tensor:
        y = _apply_node(self.elem_nodes, self.a_blocks, x, self.n_dofs, self.slots)
        return _add_fix(_total(y, self.tp), x, self.a_fix)


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


def _scatter_diag(slots: NodeSum, diag_e):
    """(E, 30) element diagonals -> (n_dofs,) assembled diagonal."""
    return slots(diag_e.reshape(-1, 3)).reshape(-1)


def _orphan_fixes(k_blocks, rho_vol, m_unit, slots: NodeSum):
    """Diagonal parking for dofs no element touches (orphan/padding vertices): a stiffness
    over a mass at ~100x the pencil's own lambda_max keeps their eigenvalues far above any
    audible window instead of leaving a singular 0/0 pencil block."""
    k_diag = _scatter_diag(slots, torch.diagonal(k_blocks, dim1=1, dim2=2))
    m_diag = _scatter_diag(slots, rho_vol[:, None] * torch.diagonal(m_unit)[None, :])
    touched = (slots.lengths > 0).repeat_interleave(3)
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
    device="cuda",
) -> ElementOperators:
    """Build the element-form pencil operators for a (filtered) tet mesh on `device`.
    The element blocks are formed on the host in numpy (one vectorized pass) and uploaded."""
    device = resolve_device(device)
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
    slots = NodeSum.of(nodes, quad.node_count)
    k_fix, m_fix = _orphan_fixes(k_blocks, rho_vol, m_unit, slots)
    return ElementOperators(nodes, k_blocks, rho_vol, m_unit, k_fix, m_fix, n_dofs,
                            slots=slots)


def pencil_diagonals(ops: ElementOperators):
    """diag(K) and diag(M), scattered from the element blocks (Jacobi preconditioning)."""
    k_diag = _scatter_diag(ops.slots, torch.diagonal(ops.k_blocks, dim1=1, dim2=2))
    m_diag = _scatter_diag(ops.slots,
                           ops.rho_vol[:, None] * torch.diagonal(ops.m_unit)[None, :])
    return _total(k_diag, ops.tp) + ops.k_fix, _total(m_diag, ops.tp) + ops.m_fix
