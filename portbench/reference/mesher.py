"""The reference's own tet mesher: a frozen copy of the repository's Delaunay mesher
(tetmesher.cpp beside this file), compiled by the host C++ compiler into the checkout's
build/portbench/tetmesher/<hash>/ and called through its C interface. The program builds
and loads its own copy; nothing here touches that build."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "tetmesher.cpp"
ROOT = Path(__file__).resolve().parents[2] / "build" / "portbench" / "tetmesher"
FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
_LIB = None


def library() -> ctypes.CDLL:
    """The reference mesher, compiled on first use (a fixed directory keyed by the source,
    the flags and the compiler, so a second run loads it)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    cxx = next((shutil.which(c) for c in (os.environ.get("CXX"), "g++", "c++") if c and
                shutil.which(c)), None)
    if cxx is None:
        raise RuntimeError("no C++ compiler for the reference mesher")
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join((cxx, version, *FLAGS)).encode())
    out = ROOT / key.hexdigest()[:16] / "libreftetmesher.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
            tmp_out = Path(tmp) / out.name
            proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp_out), str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building the reference mesher failed:\n{proc.stderr}")
            os.replace(tmp_out, out)
    lib = ctypes.CDLL(str(out))
    f64, u64 = ctypes.c_double, ctypes.c_uint64
    pd, pu32, pu64 = (ctypes.POINTER(t) for t in (f64, ctypes.c_uint32, u64))
    lib.tetmesh_delaunay.restype = ctypes.c_int
    lib.tetmesh_delaunay.argtypes = [pd, u64, pu32, u64, f64, f64, pd, pu32, pu64, pd, pu64, pd]
    _LIB = lib
    return lib


def delaunay(points, tris, lattice_h: float):
    """Tets of a closed surface (surface vertex ids kept, no quality refinement):
    returns (points (N, 3) float64, tets (E, 4) int64). Two calls: count, then copy."""
    lib = library()
    pts = np.ascontiguousarray(points, np.float64)
    tt = np.ascontiguousarray(tris, np.uint32)
    p_pts = pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    p_tris = tt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    scale, n_tets, n_pts = ctypes.c_double(), ctypes.c_uint64(0), ctypes.c_uint64(0)
    prof = (ctypes.c_double * 10)()
    rc = lib.tetmesh_delaunay(p_pts, len(pts), p_tris, len(tt), lattice_h, 0.0,
                              ctypes.byref(scale), None, ctypes.byref(n_tets), None,
                              ctypes.byref(n_pts), prof)
    if rc != 0 or n_tets.value == 0:
        raise RuntimeError(f"reference mesher failed ({rc}, {n_tets.value} tets)")
    out_tets = np.empty((n_tets.value, 4), np.uint32)
    out_pts = np.empty((n_pts.value, 3), np.float64)
    cap_t, cap_p = ctypes.c_uint64(n_tets.value), ctypes.c_uint64(n_pts.value)
    rc = lib.tetmesh_delaunay(p_pts, len(pts), p_tris, len(tt), lattice_h, 0.0,
                              ctypes.byref(scale),
                              out_tets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                              ctypes.byref(cap_t),
                              out_pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                              ctypes.byref(cap_p), prof)
    if rc != 0:
        raise RuntimeError(f"reference mesher copy pass failed ({rc})")
    return out_pts[:cap_p.value], out_tets[:cap_t.value].astype(np.int64)
