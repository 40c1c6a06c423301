"""Exact unit-volume integrals of the 10-node quadratic tetrahedral shape functions.

Shape functions in barycentric coordinates (l0..l3):
  corners (a = 0..3):  N_a = l_a (2 l_a - 1)
  edges   (e = 0..5):  N_{4+e} = 4 l_i l_j  with (i, j) = EDGE_CORNERS[e]

All integrals over a straight-sided tet are polynomials in the barycentric coordinates, so
the factorial formula  int l0^e0 l1^e1 l2^e2 l3^e3 dV = 6V * prod(e_i!) / (sum(e_i) + 3)!
evaluates them exactly. Computed once at import with exact rational arithmetic.

Semantics mirror the reference's QuadBasis (src/audio/mesh2modes.cpp:167-237); the tables
here are derived independently from the standard quadratic-tet shape functions.
"""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache
from math import factorial

import numpy as np

NUM_QUAD_NODES = 10
# Local edge nodes 4..9 sit at the midpoints of these corner pairs.
EDGE_CORNERS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))

# A barycentric polynomial: {(e0, e1, e2, e3): coeff} with exact Fraction coefficients.
_Poly = dict


def _mono(coeff, exps) -> _Poly:
    return {tuple(exps): Fraction(coeff)}


def _add(a: _Poly, b: _Poly) -> _Poly:
    out = dict(a)
    for e, c in b.items():
        out[e] = out.get(e, Fraction(0)) + c
    return out


def _mul(a: _Poly, b: _Poly) -> _Poly:
    out: _Poly = {}
    for ea, ca in a.items():
        for eb, cb in b.items():
            e = tuple(x + y for x, y in zip(ea, eb))
            out[e] = out.get(e, Fraction(0)) + ca * cb
    return out


def _unit_integral(p: _Poly) -> Fraction:
    """int p dV over a straight-sided tet, divided by its volume."""
    total = Fraction(0)
    for e, c in p.items():
        num = Fraction(6)
        for x in e:
            num *= factorial(x)
        total += c * num / factorial(sum(e) + 3)
    return total


def _shape_functions():
    """The 10 shape functions and their barycentric partial derivatives dN/dl_k."""
    n = [None] * NUM_QUAD_NODES
    dn = [[{} for _ in range(4)] for _ in range(NUM_QUAD_NODES)]
    for i in range(4):
        e_i = [1 if k == i else 0 for k in range(4)]
        e_2i = [2 if k == i else 0 for k in range(4)]
        n[i] = _add(_mono(2, e_2i), _mono(-1, e_i))  # l_i (2 l_i - 1)
        dn[i][i] = _add(_mono(4, e_i), _mono(-1, (0, 0, 0, 0)))  # 4 l_i - 1
    for e, (i, j) in enumerate(EDGE_CORNERS):
        exps = [1 if k in (i, j) else 0 for k in range(4)]
        n[4 + e] = _mono(4, exps)  # 4 l_i l_j
        dn[4 + e][i] = _mono(4, [1 if k == j else 0 for k in range(4)])
        dn[4 + e][j] = _mono(4, [1 if k == i else 0 for k in range(4)])
    return n, dn


@lru_cache(maxsize=1)
def quad_basis():
    """(mass, grad) exact integral tables as float64 arrays.

    mass[a, c]        = int N_a N_c dV / V                       shape (10, 10)
    grad[a, k, c, l]  = int (dN_a/dl_k)(dN_c/dl_l) dV / V        shape (10, 4, 10, 4)
    """
    n, dn = _shape_functions()
    mass = np.zeros((NUM_QUAD_NODES, NUM_QUAD_NODES))
    grad = np.zeros((NUM_QUAD_NODES, 4, NUM_QUAD_NODES, 4))
    for a in range(NUM_QUAD_NODES):
        for c in range(NUM_QUAD_NODES):
            mass[a, c] = float(_unit_integral(_mul(n[a], n[c])))
            for k in range(4):
                if not dn[a][k]:
                    continue
                for l in range(4):
                    if not dn[c][l]:
                        continue
                    grad[a, k, c, l] = float(_unit_integral(_mul(dn[a][k], dn[c][l])))
    mass.setflags(write=False)
    grad.setflags(write=False)
    return mass, grad
