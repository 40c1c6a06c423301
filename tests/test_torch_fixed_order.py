"""Every element sum on the port's solve path adds in one fixed order: each node's
(element, local) slots ascending for the applies, the diagonals and the touched count
(fem/assembly.py:NodeSum), and each aggregate pair's contributions in (element, i, j) order
for the AMG's Galerkin coarse pencil (solve/amg.py:_add_in_order). index_add_ adds with
atomics on a CUDA tensor, so a solve repeated on the card differed in its last bits and in
its modes' signs; on the CPU index_add_ adds in slot order, so the fixed-order sums equal the
index_add_ forms bit for bit here, which is what these tests hold. The element-sharded apply
is held to the whole one in tests/test_torch_parallel.py.
"""

import numpy as np
import pytest
import torch

from mesheditor_tpu_torch import SolverConfig, mesh2modes
from mesheditor_tpu_torch.fem import (assemble_element_matrices, build_quad_mesh,
                                      filter_degenerate, pencil_diagonals)
from mesheditor_tpu_torch.materials import CERAMIC
from mesheditor_tpu_torch.mesh import bar_tets
from mesheditor_tpu_torch.solve import amg, lobpcg

SIGMA = -((2 * np.pi * 20.0) ** 2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bar():
    """The solve tests' bar with one point no tet touches (an orphan node: an empty sum)."""
    mesh = bar_tets(0.2, 0.06, 0.05, 7, 3, 3)
    points = np.concatenate([mesh.points, [[1.0, 1.0, 1.0]]])
    kept = filter_degenerate(points, mesh.tets)
    quad = build_quad_mesh(kept, points.shape[0])
    ops = assemble_element_matrices(points, kept, CERAMIC.properties, quad, device="cpu")
    return mesh, points, kept, quad, ops


def index_add_diag(elem_nodes, diag_e, n_dofs):
    """The diagonal scatter as index_add_ forms it."""
    y = torch.zeros(n_dofs // 3, 3, dtype=diag_e.dtype)
    y.index_add_(0, elem_nodes.reshape(-1), diag_e.reshape(-1, 3))
    return y.reshape(-1)


def test_no_unordered_sum_is_left_on_the_solve_path(monkeypatch):
    """With index_add_ and scatter_add_ (both forms) raising, the device engine's whole solve
    on the bar still runs: assembly, AMG build, seed, iteration."""
    def refuse(*args, **kwargs):
        raise AssertionError("an unordered sum on the solve path")

    for name in ("index_add_", "index_add", "scatter_add_", "scatter_add"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "index_add", refuse)
    monkeypatch.setattr(torch, "scatter_add", refuse)
    mesh = bar_tets(0.2, 0.06, 0.05, 7, 3, 3)
    before = (lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES)
    res = mesh2modes(mesh, CERAMIC.properties, mesh.points[::20][:5],
                     config=SolverConfig(small_n=0), device="cpu")
    assert (lobpcg.DEVICE_SOLVES - before[0], lobpcg.HOST_SOLVES - before[1]) == (1, 0)
    assert res.modes.num_modes > 0


@pytest.mark.parametrize("which", ["K", "M", "A"])
def test_applies_sum_each_node_in_ascending_slot_order(bar, which):
    """K, M and the shifted A on a 7-column panel equal a numpy sum over each node's slots
    in ascending order, plus the diagonal fix, bit for bit (the element products are the
    apply's own batched matmuls on the same inputs)."""
    *_, ops = bar
    shifted = ops.shifted(SIGMA)
    x = torch.as_tensor(np.random.default_rng(12).standard_normal((ops.n_dofs, 7)))
    nodes = ops.elem_nodes.numpy().reshape(-1)
    e, nn = ops.elem_nodes.shape[0], ops.n_dofs // 3
    xe = x.reshape(nn, 21).index_select(0, ops.elem_nodes.reshape(-1)).reshape(e, 30, 7)
    if which == "K":
        ye, fix, apply = torch.bmm(ops.k_blocks, xe), ops.k_fix, ops.kmat
    elif which == "M":
        ye = torch.matmul(ops.m_unit, xe) * ops.rho_vol[:, None, None]
        fix, apply = ops.m_fix, ops.mmat
    else:
        ye, fix, apply = torch.bmm(shifted.a_blocks, xe), shifted.a_fix, shifted.amat
    rows = ye.reshape(e * 10, 21).numpy()
    y = np.zeros((nn, 21))
    for slot in range(e * 10):
        y[nodes[slot]] += rows[slot]
    want = y.reshape(-1, 7) + fix.numpy()[:, None] * x.numpy()
    assert np.array_equal(apply(x).numpy(), want)
    assert np.array_equal(apply(x[:, 3]).numpy(), apply(x)[:, 3].numpy())


def test_diagonals_and_fixes_equal_the_index_add_forms(bar):
    """diag(K), diag(M) and the orphan fixes (the touched count included) are those the
    index_add_ scatters give, bit for bit; the orphan's three dofs are parked."""
    *_, ops = bar
    kd, md = pencil_diagonals(ops)
    k_e = torch.diagonal(ops.k_blocks, dim1=1, dim2=2)
    m_e = ops.rho_vol[:, None] * torch.diagonal(ops.m_unit)[None, :]
    k_old = index_add_diag(ops.elem_nodes, k_e, ops.n_dofs)
    m_old = index_add_diag(ops.elem_nodes, m_e, ops.n_dofs)
    assert torch.equal(kd, k_old + ops.k_fix) and torch.equal(md, m_old + ops.m_fix)
    touched = index_add_diag(ops.elem_nodes, torch.ones_like(k_e), ops.n_dofs) > 0
    assert int((~touched).sum()) == 3
    live = touched & (m_old > 0)
    lam_est = torch.max(k_old[live] / m_old[live])
    m_scale = torch.quantile(m_old[live], 0.5)
    assert torch.equal(ops.k_fix, torch.where(touched, 0.0, 100.0 * lam_est * m_scale))
    assert torch.equal(ops.m_fix, torch.where(touched, 0.0, m_scale))


def test_add_in_order_equals_index_add():
    """acc[ids] += rows as the coarse pencil adds them: index_add_'s bits, with targets
    hit many times, once and not at all, and an accumulator that is not zero."""
    rng = np.random.default_rng(3)
    acc = torch.as_tensor(rng.standard_normal((50, 4)))
    ids = torch.as_tensor(rng.integers(0, 40, 500))
    rows = torch.as_tensor(rng.standard_normal((500, 4)) * 10.0 ** rng.integers(-8, 8, (500, 1)))
    want = acc.clone().index_add_(0, ids, rows)
    amg._add_in_order(acc, ids, rows)
    assert torch.equal(acc, want)


def index_add_coarse_pencil(ops, w, agg, nagg, chunk):
    """amg._coarse_assemble_pencil with index_add_ accumulating the chunks' blocks."""
    en = ops.elem_nodes
    acc = torch.zeros(nagg * nagg, 72, dtype=torch.float64)
    eye10 = torch.eye(10, dtype=torch.float64)
    for s in range(0, en.shape[0], chunk):
        en_c = en[s : s + chunk]
        ch = en_c.shape[0]
        wn = w.index_select(0, en_c.reshape(-1)).reshape(ch, 10, 3, 6)
        pe = (wn[:, :, :, None, :] * eye10[None, :, None, :, None]).reshape(ch, 30, 60)
        bl = torch.stack([ops.k_blocks[s : s + ch],
                          ops.rho_vol[s : s + ch, None, None] * ops.m_unit[None]])
        t = pe.transpose(1, 2)[None] @ (bl @ pe[None])
        t = t.reshape(2, ch, 10, 6, 10, 6).permute(1, 2, 4, 0, 3, 5)
        ag = agg.index_select(0, en_c.reshape(-1)).reshape(ch, 10)
        ids = (ag[:, :, None] * nagg + ag[:, None, :]).reshape(-1)
        acc.index_add_(0, ids, t.reshape(ch * 100, 72))
    acc = acc.reshape(nagg, nagg, 2, 6, 6).permute(2, 0, 3, 1, 4).reshape(2, 6 * nagg, 6 * nagg)
    return acc[0], acc[1]


@pytest.mark.parametrize("chunk", [amg._AC_CHUNK, 100])
def test_coarse_pencil_equals_the_index_add_form(bar, chunk, monkeypatch):
    """The Galerkin coarse pencil (Kc, Mc) equals the index_add_ form's bit for bit, in one
    chunk of elements and over several (a chunk of 100 of the bar's 378 elements)."""
    mesh, points, kept, quad, ops = bar
    pre = amg.build_amg(points, kept, quad, ops, *pencil_diagonals(ops), SIGMA)
    monkeypatch.setattr(amg, "_AC_CHUNK", chunk)
    kc, mc = amg._coarse_assemble_pencil(ops, pre.w, pre.agg, pre.nagg)
    k_old, m_old = index_add_coarse_pencil(ops, pre.w, pre.agg, pre.nagg, chunk)
    assert torch.equal(kc, k_old) and torch.equal(mc, m_old)
    assert torch.equal(mc, pre.mc)


def test_a_solve_repeats_bit_for_bit():
    """Two device-engine solves of one mesh give the same eigenvalues and mode shapes, bit
    for bit (on the card too, where index_add_ did not)."""
    mesh = bar_tets(0.2, 0.06, 0.05, 7, 3, 3)
    cfg = SolverConfig(num_modes=20, num_fem_modes=20, small_n=0)
    a, b = (mesh2modes(mesh, CERAMIC.properties, mesh.points[::20][:5], config=cfg,
                       device="cpu") for _ in range(2))
    assert np.array_equal(a.summary.eigenvalues, b.summary.eigenvalues)
    assert np.array_equal(a.modes.shapes, b.modes.shapes)
