"""The eigensolver against scipy's shift-invert on a small bar (counterpart of
scripts/check_eigensolver.py). By default, as the reference's script does, the port's
`lobpcg_pencil` on the pencil's operator callables with no preconditioner: the closure
engine, whose inner solve is Jacobi-preconditioned CG (with --f32-pencil, CG in float32 on
float32 copies of the pencil); with --amg, the element form with the AMG preconditioner,
always through the device engine (small_n=0). The pencil is solved on --device, beside
scipy's `eigsh` on the same pencil, with the largest relative frequency error over the
audible modes and the engine's six lowest (rigid) eigenvalues.

Usage: python -m mesheditor_tpu_torch.scripts.check_eigensolver [nx ny nz [nev [inner]]]
       [--f32-pencil | --amg [--tol-accept T]] [--device cuda|cpu]
Exits 1 when the engine returns no eigenpair.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def f32_pencil(ops):
    """kmat_pc, mmat_pc: the pencil's products in float32, from float32 sparse copies of
    its assembled CSR matrices (`_pencil_csr`) on the pencil's device, called as
    f(op_state, x) on float32 panels (the closure engine's float32 preconditioner)."""
    import torch

    from ..solve.lobpcg import _pencil_csr

    def sparse(a):
        coo = a.tocoo()
        idx = torch.as_tensor(np.stack([coo.row, coo.col]).astype(np.int64))
        with torch.sparse.check_sparse_tensor_invariants():
            return torch.sparse_coo_tensor(idx, torch.as_tensor(coo.data, dtype=torch.float32),
                                           a.shape, device=ops.device).coalesce()

    k32, m32 = (sparse(a) for a in _pencil_csr(ops))
    return (lambda _state, x: torch.sparse.mm(k32, x),
            lambda _state, x: torch.sparse.mm(m32, x))


def op_rule(iterations: int, inner: int, refreshes: int = 0) -> int:
    """The closure engine's panel count: 3 at the start, 2 + 2 * inner an iteration, 2 a
    refresh."""
    return 3 + iterations * (2 + 2 * inner) + 2 * refreshes


def check(res=(8, 2, 2), nev=20, inner=24, device="cuda", tol_accept=1e-4, amg=False,
          f32=False):
    """Solve the 0.3 x 0.05 x 0.05 m bar at `res` cells both ways: by default the closure
    engine on the pencil's callables (tol 1e-8, at most 200 iterations, `inner` CG steps,
    Jacobi in float64 or, with `f32`, on the float32 pencil); with `amg`, the element
    engine with the AMG preconditioner and its acceptance floor at `tol_accept`, as
    lobpcg_pencil takes it. Returns a dict with the engine, the two frequency lists
    (audible modes), the largest relative error, the engine's six lowest eigenvalues, its
    iterations, its panel applications and the two walls; None for the engine's side when
    it returned nothing."""
    import scipy.sparse.linalg as spla
    import torch

    from .._device import card_label, resolve_device
    from ..fem import (assemble_element_matrices, build_quad_mesh, filter_degenerate,
                       pencil_diagonals)
    from ..mesh import bar_tets
    from ..solve.amg import build_amg
    from ..solve.lobpcg import _pencil_csr, lobpcg_pencil
    from ..types import AcousticMaterialProperties

    device = resolve_device(device)
    mesh = bar_tets(0.3, 0.05, 0.05, *res)
    mat = AcousticMaterialProperties(1000, 1e7, 0.0)
    kept = filter_degenerate(mesh.points, mesh.tets)
    quad = build_quad_mesh(kept, mesh.points.shape[0])
    ops = assemble_element_matrices(mesh.points, kept, mat, quad, device=device)
    n = ops.n_dofs
    engine = "amg" if amg else "closure, float32 pencil" if f32 else "closure, Jacobi"
    print(f"tets={kept.shape[0]} quad_nodes={quad.node_count} n_dofs={n} engine={engine} on "
          f"{card_label(device)}", flush=True)

    k, m = _pencil_csr(ops)
    sigma = -((2 * np.pi * 20.0) ** 2)
    t0 = time.perf_counter()
    v0 = np.random.default_rng(0).uniform(-1.0, 1.0, n)
    vals_ref = np.sort(spla.eigsh(k, k=nev, M=m, sigma=sigma, which="LM", v0=v0,
                                  return_eigenvectors=False))
    scipy_s = time.perf_counter() - t0
    print(f"scipy eigsh: {scipy_s:.2f}s", flush=True)

    kd, md = pencil_diagonals(ops)
    pc = dict(zip(("kmat_pc", "mmat_pc"), f32_pencil(ops))) if f32 and not amg else {}
    pre = build_amg(mesh.points, kept, quad, ops, kd, md, sigma) if amg else None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    if amg:
        res_ = lobpcg_pencil(ops, nev, sigma=sigma, precond=pre, tol=1e-8, max_iters=200,
                             inner_iters=inner, small_n=0, tol_accept=tol_accept)
    else:
        res_ = lobpcg_pencil(ops.kmat, ops.mmat, kd, md, n, nev, sigma=sigma, tol=1e-8,
                             max_iters=200, inner_iters=inner, **pc)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    engine_s = time.perf_counter() - t0
    print(f"lobpcg: {engine_s:.2f}s iters={res_.iterations} ops={res_.op_applications}",
          flush=True)
    f_ref = np.sqrt(np.maximum(vals_ref, 0)) / (2 * np.pi)
    audible = f_ref > 20
    out = {"n_dofs": n, "engine": engine, "scipy_s": scipy_s, "engine_s": engine_s,
           "iterations": res_.iterations, "op_applications": res_.op_applications,
           "ref_hz": f_ref[audible].tolist(), "got_hz": None, "max_rel_err": None,
           "rigid": None}
    if res_.eigenvalues.size == 0:
        return out
    lam = res_.eigenvalues
    f_got = np.sqrt(np.maximum(lam, 0)) / (2 * np.pi)
    rel = np.abs(f_got - f_ref) / np.maximum(f_ref, 1e-9)
    out.update(got_hz=f_got[audible].tolist(), max_rel_err=float(rel[audible].max()),
               rigid=lam[:6].tolist())
    print("freqs ref:", np.round(f_ref[audible][:10], 2))
    print("freqs got:", np.round(f_got[audible][:10], 2))
    print(f"max rel freq err (audible): {out['max_rel_err']:.2e}")
    print(f"rigid eigenvalues got: {lam[:6]}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", type=int, help="nx ny nz [nev [inner]]")
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--amg", action="store_true",
                       help="the element form with the AMG preconditioner (device engine)")
    which.add_argument("--f32-pencil", action="store_true",
                       help="the closure engine's CG in float32 on float32 copies of the pencil")
    ap.add_argument("--tol-accept", type=float, default=1e-4,
                    help="with --amg: the engine's acceptance floor (lobpcg_pencil's "
                         "tol_accept)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    s = args.sizes
    res = tuple(s[:3]) if len(s) >= 3 else (8, 2, 2)
    nev = s[3] if len(s) > 3 else 20
    inner = s[4] if len(s) > 4 else 24
    out = check(res, nev, inner, args.device, args.tol_accept, amg=args.amg,
                f32=args.f32_pencil)
    if out["got_hz"] is None:
        print("LOBPCG FAILED to converge")
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
