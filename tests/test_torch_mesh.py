"""The port's surface-meshing modules against the JAX package's on the same inputs.

simplify, the voxel mesher, the half-edge structure, the iso-surface meshes and the obj/ply
files are copies, so their outputs are held equal array for array. The Delaunay mesher is
the port's own build of native/tetmesher.cpp: it is held to the checked-in library, which
the reference loads, point for point, tet for tet and counter for counter."""

from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

from mesheditor_tpu.mesh import cdt as ref_cdt
from mesheditor_tpu.mesh import halfedge as ref_halfedge
from mesheditor_tpu.mesh import isosurface as ref_iso
from mesheditor_tpu.mesh import obj_io as ref_obj
from mesheditor_tpu.mesh import ply_io as ref_ply
from mesheditor_tpu.mesh import simplify as ref_simplify
from mesheditor_tpu.mesh import voxel_tets as ref_voxel

from mesheditor_tpu_torch import _build
from mesheditor_tpu_torch.mesh import (cdt, cuboid_surface, halfedge, icosphere_surface,
                                       isosurface, obj_io, ply_io, simplify, torus_surface,
                                       voxel_tets)


def _surface(name):
    if name == "torus":
        return torus_surface(0.06, 0.025, 24, 12)
    if name == "sphere":
        p, t = icosphere_surface(2)
        return p * 0.05, t
    if name == "blob":
        return isosurface.noise_blob_surface(seed=3, n=14)
    raise KeyError(name)


@pytest.mark.parametrize("name,ratio", [("torus", 0.5), ("sphere", 0.3), ("blob", 0.4),
                                        ("torus", 1.0)])
def test_simplify_surface_equals_reference(name, ratio):
    pts, tris = _surface(name)
    p, t = simplify.simplify_surface(pts, tris, ratio)
    rp, rt = ref_simplify.simplify_surface(pts, tris, ratio)
    np.testing.assert_array_equal(p, rp)
    np.testing.assert_array_equal(t, rt)
    assert t.dtype == rt.dtype
    if ratio < 1.0:
        assert t.shape[0] < tris.shape[0]


@pytest.mark.parametrize("name,resolution", [("torus", 12), ("sphere", 8)])
def test_generate_tets_equals_reference_and_counts(name, resolution):
    pts, tris = _surface(name)
    before = voxel_tets.VOXEL_MESHES
    m = voxel_tets.generate_tets(pts, tris, resolution=resolution)
    assert voxel_tets.VOXEL_MESHES == before + 1
    r = ref_voxel.generate_tets(pts, tris, resolution=resolution)
    np.testing.assert_array_equal(m.points, r.points)
    np.testing.assert_array_equal(m.tets, r.tets)


def test_generate_tets_thin_shell_raises_and_counts_nothing():
    pts, tris = _surface("sphere")
    shell_p = np.vstack([pts, pts * 0.98])
    shell_t = np.vstack([tris, tris[:, ::-1] + pts.shape[0]])
    before = voxel_tets.VOXEL_MESHES
    with pytest.raises(ValueError, match="no interior cells"):
        voxel_tets.generate_tets(shell_p, shell_t, resolution=8)
    assert voxel_tets.VOXEL_MESHES == before


@pytest.mark.parametrize("name", ["torus", "blob"])
def test_build_halfedge_equals_reference(name):
    pts, tris = _surface(name)
    he, rhe = halfedge.build_halfedge(pts, tris), ref_halfedge.build_halfedge(pts, tris)
    for field in ("positions", "triangles", "dest", "twin", "vertex_halfedge"):
        np.testing.assert_array_equal(getattr(he, field), getattr(rhe, field), err_msg=field)
    assert he.is_closed() == rhe.is_closed() == (name == "torus")
    np.testing.assert_array_equal(he.edges(), rhe.edges())
    np.testing.assert_array_equal(he.vertex_normals(), rhe.vertex_normals())
    np.testing.assert_array_equal(he.vertex_neighbors(5), rhe.vertex_neighbors(5))
    open_he = halfedge.build_halfedge(pts, tris[:-3])
    np.testing.assert_array_equal(
        open_he.boundary_halfedges(),
        ref_halfedge.build_halfedge(pts, tris[:-3]).boundary_halfedges())
    assert open_he.boundary_halfedges().size > 0


@pytest.mark.parametrize("make,kwargs", [
    ("noise_blob_surface", dict(seed=1, n=12)),
    ("noise_blob_surface", dict(seed=2, n=12, roughness=0.3)),
    ("gyroid_shell_surface", dict(n=12)),
])
def test_isosurface_meshes_equal_reference(make, kwargs):
    p, t = getattr(isosurface, make)(**kwargs)
    rp, rt = getattr(ref_iso, make)(**kwargs)
    np.testing.assert_array_equal(p, rp)
    np.testing.assert_array_equal(t, rt)
    assert t.shape[0] > 100


@pytest.mark.parametrize("fmt", ["obj", "ply", "ply-ascii"])
def test_mesh_files_round_trip_and_equal_reference_bytes(tmp_path, fmt):
    pts, tris = _surface("torus")
    port_path, ref_path = tmp_path / f"port.{fmt[:3]}", tmp_path / f"ref.{fmt[:3]}"
    if fmt == "obj":
        obj_io.save_obj(port_path, pts, tris)
        ref_obj.save_obj(ref_path, pts, tris)
        load, ref_load = obj_io.load_obj, ref_obj.load_obj
    else:
        ply_io.save_ply(port_path, pts, tris, binary=fmt == "ply")
        ref_ply.save_ply(ref_path, pts, tris, binary=fmt == "ply")
        load, ref_load = ply_io.load_ply, ref_ply.load_ply
    assert port_path.read_bytes() == ref_path.read_bytes()
    p, t = load(ref_path)  # each package reads the other's file
    rp, rt = ref_load(port_path)
    np.testing.assert_array_equal(p, rp)
    np.testing.assert_array_equal(t, rt)
    np.testing.assert_array_equal(t, tris)
    np.testing.assert_allclose(p, pts, rtol=0, atol=1e-6 * np.abs(pts).max())


def _soup():
    """The degenerate + duplicate face soup of the reference's mesher tests."""
    pts, tris = cuboid_surface((0.1, 0.1, 0.1))
    degen = np.array([[0, 1, 1], [2, 2, 3]], np.uint32)
    return pts, np.vstack([tris, tris[:4], degen])


@pytest.mark.parametrize("case,kwargs", [
    ("torus", dict(lattice_h=0.17 / 12)),
    ("torus", dict(lattice_h=0.17 / 10, quality_bound=2.0)),
    ("soup", dict()),
])
def test_delaunay_mesher_build_equals_checked_in_library(case, kwargs):
    pts, tris = _soup() if case == "soup" else _surface("torus")
    prof, ref_prof = cdt.TetProfile(), ref_cdt.TetProfile()
    before = cdt.NATIVE_MESHES
    m = cdt.generate_tets_delaunay(pts, tris, profile=prof, **kwargs)
    assert cdt.NATIVE_MESHES == before + 1
    r = ref_cdt.generate_tets_delaunay(pts, tris, profile=ref_prof, **kwargs)
    np.testing.assert_array_equal(m.points, r.points)
    np.testing.assert_array_equal(m.tets, r.tets)
    assert asdict(prof) == asdict(ref_prof)
    assert prof.tets_kept == m.tets.shape[0] > 0
    np.testing.assert_array_equal(m.points[: pts.shape[0]], pts)  # the surface is kept


def test_mesher_library_is_built_outside_native_and_keyed_by_source():
    lib = _build.mesher_path()
    repo = Path(_build.__file__).resolve().parents[1]
    assert lib.is_relative_to(repo / "build" / "native")
    cdt.generate_tets_delaunay(*cuboid_surface((0.1, 0.1, 0.1)))
    assert lib.exists()
    assert _build.load_tetmesher()._name == str(lib)


def test_clean_surface_soup_equals_reference():
    _pts, soup = _soup()
    tt, rep = cdt.clean_surface_soup(soup)
    rtt, rrep = ref_cdt.clean_surface_soup(soup)
    np.testing.assert_array_equal(tt, rtt)
    assert rep == rrep and rep["degenerate"] == 2 and rep["duplicates"] == 4


@pytest.mark.parametrize("case,match", [
    ("open", "not a closed surface|not watertight"),
    ("empty", "empty after soup cleanup"),
])
def test_delaunay_mesher_refuses_with_value_error(case, match):
    pts, tris = cuboid_surface((0.1, 0.1, 0.1))
    tris = tris[:-2] if case == "open" else tris[:1]
    before = cdt.NATIVE_MESHES
    with pytest.raises(ValueError, match=match):
        cdt.generate_tets_delaunay(pts, tris)
    with pytest.raises(ValueError, match=match):
        ref_cdt.generate_tets_delaunay(pts, tris)
    assert cdt.NATIVE_MESHES == before


def test_mesher_that_cannot_be_built_raises_not_value_error(tmp_path, monkeypatch):
    """A library that does not build is an error of its own kind, so that solve_surface
    cannot take it for an unmeshable surface and answer with voxels."""
    from mesheditor_tpu_torch import api
    from mesheditor_tpu_torch.materials import GLASS

    broken = tmp_path / "tetmesher.cpp"
    broken.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="building tetmesher.cpp failed") as err:
        _build.build_tetmesher(broken)
    assert "error" in str(err.value)  # the compiler's output is in the message
    assert not _build.mesher_path(broken).exists()
    with pytest.raises(RuntimeError, match="source not found"):
        _build.build_tetmesher(tmp_path / "missing.cpp")

    real_build = _build.build_tetmesher
    monkeypatch.setattr(_build, "_MESHER", None)
    monkeypatch.setattr(_build, "build_tetmesher", lambda: real_build(broken))
    pts, tris = _surface("sphere")
    voxel_before = voxel_tets.VOXEL_MESHES
    with pytest.raises(RuntimeError, match="building tetmesher.cpp failed"):
        api.solve_surface(pts, tris, GLASS.properties, tet_resolution=6, device="cpu")
    assert voxel_tets.VOXEL_MESHES == voxel_before  # no voxel answer
