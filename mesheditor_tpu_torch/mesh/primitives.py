"""Mesh generators: structured tet meshes and parametric surface primitives.

The tet generators produce the structured Kuhn-subdivided grids the solver oracles need
(reference: tests/ModalSolverTest.cpp:37-68); the surface primitives mirror the editor's
parametric shapes (reference: src/mesh/Primitives.h, PrimitiveType.h:14-52).
All generators are vectorized numpy; outputs are (points f64 (n,3), tets/tris u32).
"""

from __future__ import annotations

import numpy as np

from ..types import TetMesh

# Six tets sharing the c0-c7 main diagonal of a grid cell, one per axis-order path (Kuhn).
_KUHN_CORNERS = np.array(
    [[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]],
    dtype=np.int64,
)


def box_tets(extents: tuple[float, float, float], resolution: tuple[int, int, int]) -> TetMesh:
    """Structured tet mesh of an axis-aligned box: (nx+1)(ny+1)(nz+1) vertices, each cell
    split into six tetrahedra around its main diagonal (Kuhn subdivision)."""
    lx, ly, lz = extents
    nx, ny, nz = resolution
    vx, vy, vz = nx + 1, ny + 1, nz + 1
    xs = np.linspace(0.0, lx, vx)
    ys = np.linspace(0.0, ly, vy)
    zs = np.linspace(0.0, lz, vz)
    grid = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1)  # (vx, vy, vz, 3)
    points = grid.reshape(-1, 3)

    def vid(i, j, k):  # match reference vertex numbering: ((i*vy + j)*vz + k)
        return (i * vy + j) * vz + k

    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    ii, jj, kk = ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)
    corners = np.stack(
        [
            vid(ii, jj, kk), vid(ii + 1, jj, kk), vid(ii, jj + 1, kk), vid(ii + 1, jj + 1, kk),
            vid(ii, jj, kk + 1), vid(ii + 1, jj, kk + 1), vid(ii, jj + 1, kk + 1), vid(ii + 1, jj + 1, kk + 1),
        ],
        axis=-1,
    )  # (cells, 8)
    tets = corners[:, _KUHN_CORNERS].reshape(-1, 4)  # (cells*6, 4)
    return TetMesh(points=points, tets=tets.astype(np.uint32))


def bar_tets(length: float, width: float, thickness: float, nx: int, ny: int, nz: int) -> TetMesh:
    """The free-free bar of the solver oracle tests (x, y, z extents in meters)."""
    return box_tets((length, width, thickness), (nx, ny, nz))


def grid_box_surface(k: int) -> tuple[np.ndarray, np.ndarray]:
    """Axis-aligned unit box as a k x k grid per face — heavy in exact degeneracies
    (reference: tests/ModalSolverTest.cpp:147-170). Returns (points, tris)."""
    ids: dict[tuple[int, int, int], int] = {}
    points: list[tuple[float, float, float]] = []
    tris: list[int] = []

    def vid(x: int, y: int, z: int) -> int:
        key = (x, y, z)
        if key not in ids:
            ids[key] = len(points)
            points.append((x / k, y / k, z / k))
        return ids[key]

    def face(corner, flip=False):
        for i in range(k):
            for j in range(k):
                a, b, c, d = corner(i, j), corner(i + 1, j), corner(i + 1, j + 1), corner(i, j + 1)
                if flip:
                    tris.extend((a, c, b, a, d, c))
                else:
                    tris.extend((a, b, c, a, c, d))

    # Consistently outward-wound (enclosed volume and curvature depend on it).
    face(lambda i, j: vid(i, j, 0), flip=True)
    face(lambda i, j: vid(i, j, k))
    face(lambda i, j: vid(i, 0, j))
    face(lambda i, j: vid(i, k, j), flip=True)
    face(lambda i, j: vid(0, i, j), flip=True)
    face(lambda i, j: vid(k, i, j))
    return np.asarray(points, dtype=np.float64), np.asarray(tris, dtype=np.uint32).reshape(-1, 3)


def icosphere_surface(subdivisions: int, noise: float = 0.0, seed: int = 0):
    """Icosphere with optional radial noise (reference: tests/ModalSolverTest.cpp:173-204)."""
    phi = (1 + np.sqrt(5.0)) / 2
    pts = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        dtype=np.float64,
    )
    tris = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts_list = list(pts)
    for _ in range(subdivisions):
        mid: dict[tuple[int, int], int] = {}

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in mid:
                mid[key] = len(pts_list)
                p = 0.5 * (pts_list[a] + pts_list[b])
                pts_list.append(p / np.linalg.norm(p))
            return mid[key]

        nxt = []
        for t in tris:
            ab, bc, ca = midpoint(t[0], t[1]), midpoint(t[1], t[2]), midpoint(t[2], t[0])
            nxt.extend([[t[0], ab, ca], [t[1], bc, ab], [t[2], ca, bc], [ab, bc, ca]])
        tris = np.asarray(nxt, dtype=np.int64)
    pts = np.asarray(pts_list)
    if noise > 0:
        rng = np.random.default_rng(seed)
        pts = pts * rng.uniform(1 - noise, 1 + noise, size=(pts.shape[0], 1))
    return pts, tris.astype(np.uint32)


def cuboid_surface(half_extents=(0.5, 0.5, 0.5)):
    """Axis-aligned cuboid centered at the origin."""
    hx, hy, hz = half_extents
    pts, tris = grid_box_surface(1)
    pts = (pts - 0.5) * 2.0 * np.array([hx, hy, hz])
    return pts, tris


def plane_surface(size=(1.0, 1.0), segments=(1, 1)):
    sx, sy = size
    nx, ny = segments
    xs = np.linspace(-sx / 2, sx / 2, nx + 1)
    ys = np.linspace(-sy / 2, sy / 2, ny + 1)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([gx, gy, np.zeros_like(gx)], axis=-1).reshape(-1, 3)
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    a = (ii * (ny + 1) + jj).reshape(-1)
    b = a + (ny + 1)
    c = b + 1
    d = a + 1
    tris = np.stack([np.stack([a, b, c], -1), np.stack([a, c, d], -1)], axis=1).reshape(-1, 3)
    return pts, tris.astype(np.uint32)


def uv_sphere_surface(radius=0.5, n_lat=16, n_lon=32):
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    body_lat = lat[1:-1]
    ll, mm = np.meshgrid(body_lat, lon, indexing="ij")
    pts = [np.array([[0.0, 0.0, radius]]), np.stack(
        [radius * np.sin(ll) * np.cos(mm), radius * np.sin(ll) * np.sin(mm), radius * np.cos(ll)], axis=-1
    ).reshape(-1, 3), np.array([[0.0, 0.0, -radius]])]
    pts = np.concatenate(pts)
    top, bottom = 0, pts.shape[0] - 1
    rows = n_lat - 1

    def rid(r, c):
        return 1 + r * n_lon + (c % n_lon)

    tris = []
    for c in range(n_lon):
        tris.append([top, rid(0, c), rid(0, c + 1)])
        tris.append([bottom, rid(rows - 1, c + 1), rid(rows - 1, c)])
    for r in range(rows - 1):
        for c in range(n_lon):
            a, b = rid(r, c), rid(r, c + 1)
            d, e = rid(r + 1, c), rid(r + 1, c + 1)
            tris.extend([[a, d, e], [a, e, b]])
    return pts, np.asarray(tris, dtype=np.uint32)


def torus_surface(major_radius=0.5, minor_radius=0.2, n_major=32, n_minor=16):
    u = np.linspace(0, 2 * np.pi, n_major, endpoint=False)
    v = np.linspace(0, 2 * np.pi, n_minor, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    r = major_radius + minor_radius * np.cos(vv)
    pts = np.stack([r * np.cos(uu), r * np.sin(uu), minor_radius * np.sin(vv)], axis=-1).reshape(-1, 3)

    def vid(i, j):
        return (i % n_major) * n_minor + (j % n_minor)

    ii, jj = np.meshgrid(np.arange(n_major), np.arange(n_minor), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    a, b, c, d = vid(ii, jj), vid(ii + 1, jj), vid(ii + 1, jj + 1), vid(ii, jj + 1)
    tris = np.concatenate([np.stack([a, b, c], -1), np.stack([a, c, d], -1)], axis=0)
    return pts, tris.astype(np.uint32)


def circle_surface(radius=0.5, n_seg=32):
    """Flat disc fan."""
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    pts = np.concatenate([[[0.0, 0.0, 0.0]],
                          np.stack([radius * np.cos(ang), radius * np.sin(ang),
                                    np.zeros(n_seg)], axis=-1)])
    tris = [[0, 1 + i, 1 + (i + 1) % n_seg] for i in range(n_seg)]
    return pts, np.asarray(tris, dtype=np.uint32)


def cone_surface(radius=0.5, height=1.0, n_seg=32):
    """Closed cone: apex up, disc base."""
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang),
                     np.full(n_seg, -height / 2)], axis=-1)
    pts = np.concatenate([[[0.0, 0.0, height / 2]], ring, [[0.0, 0.0, -height / 2]]])
    base_c = n_seg + 1
    tris = []
    for i in range(n_seg):
        j = (i + 1) % n_seg
        tris.append([0, 1 + i, 1 + j])  # side
        tris.append([base_c, 1 + j, 1 + i])  # base
    return pts, np.asarray(tris, dtype=np.uint32)


def cylinder_surface(radius=0.5, height=1.0, n_seg=32):
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang)], axis=-1)
    top = np.concatenate([ring, np.full((n_seg, 1), height / 2)], axis=1)
    bot = np.concatenate([ring, np.full((n_seg, 1), -height / 2)], axis=1)
    pts = np.concatenate([top, bot, [[0, 0, height / 2]], [[0, 0, -height / 2]]])
    ct, cb = 2 * n_seg, 2 * n_seg + 1
    tris = []
    for i in range(n_seg):
        j = (i + 1) % n_seg
        tris.extend([[ct, i, j], [cb, n_seg + j, n_seg + i]])  # caps
        tris.extend([[i, n_seg + i, n_seg + j], [i, n_seg + j, j]])  # side
    return pts, np.asarray(tris, dtype=np.uint32)


def shell_surface(pts: np.ndarray, tris: np.ndarray, thickness: float):
    """Closed thin shell from a closed surface: inner skin offset inward along
    area-weighted vertex normals, with flipped orientation. The thin-walled regime the
    reference's corpus lives in (RealImpact bowls/plates are 2-5% wall-thickness scans;
    MeshEditor's tests/ModalSolverTest.cpp:316-349 pins them through the mesher)."""
    pts = np.asarray(pts, dtype=np.float64)
    tris = np.asarray(tris, dtype=np.int64)
    a, b, c = pts[tris[:, 0]], pts[tris[:, 1]], pts[tris[:, 2]]
    fn = np.cross(b - a, c - a)  # area-weighted face normals (outward)
    vn = np.zeros_like(pts)
    for k in range(3):
        np.add.at(vn, tris[:, k], fn)
    norms = np.linalg.norm(vn, axis=1, keepdims=True)
    vn /= np.maximum(norms, 1e-300)
    inner = pts - thickness * vn
    n = pts.shape[0]
    tris_in = tris[:, ::-1] + n  # flipped orientation, offset ids
    return np.concatenate([pts, inner]), np.concatenate([tris, tris_in]).astype(np.uint32)


def bowl_surface(radius=0.06, thickness=0.004, n_lat=10, n_lon=32, rim_z=0.0,
                 noise: float = 0.0, seed: int = 0):
    """Hemispherical bowl shell: outer hemisphere, inner hemisphere (radius - thickness),
    flat rim annulus. Optional vertex jitter models scanned geometry. Closed, watertight,
    outward-oriented."""
    assert thickness < radius
    ang = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    ca, sa = np.cos(ang), np.sin(ang)

    def hemi(r, flip):
        # Rings from rim (theta=0, z=rim_z) toward the bottom pole (z=rim_z - r).
        rings = []
        for i in range(n_lat):
            th = (i / n_lat) * (np.pi / 2)
            rr, z = r * np.cos(th), rim_z - r * np.sin(th)
            rings.append(np.stack([rr * ca, rr * sa, np.full(n_lon, z)], axis=1))
        pole = np.array([[0.0, 0.0, rim_z - r]])
        return np.concatenate(rings + [pole])

    outer = hemi(radius, False)
    inner = hemi(radius - thickness, True)
    n_out = outer.shape[0]
    pts = np.concatenate([outer, inner])
    tris = []

    def ring_band(base, flip):
        for i in range(n_lat - 1):
            for j in range(n_lon):
                k = (j + 1) % n_lon
                a0, a1 = base + i * n_lon + j, base + i * n_lon + k
                b0, b1 = base + (i + 1) * n_lon + j, base + (i + 1) * n_lon + k
                t1, t2 = [a0, b0, a1], [a1, b0, b1]
                if flip:
                    t1, t2 = t1[::-1], t2[::-1]
                tris.extend([t1, t2])
        pole = base + n_lat * n_lon
        last = base + (n_lat - 1) * n_lon
        for j in range(n_lon):
            k = (j + 1) % n_lon
            t = [last + j, pole, last + k]
            tris.append(t[::-1] if flip else t)

    ring_band(0, False)       # outer skin, outward normals (down/out)
    ring_band(n_out, True)    # inner skin, normals point up/in (flipped)
    for j in range(n_lon):    # rim annulus at z=rim_z, normals +z
        k = (j + 1) % n_lon
        o0, o1 = j, k                      # outer rim ring (first outer ring)
        i0, i1 = n_out + j, n_out + k      # inner rim ring
        tris.extend([[o0, o1, i0], [o1, i1, i0]])
    pts = np.asarray(pts)
    if noise > 0:
        rng = np.random.default_rng(seed)
        pts = pts + rng.uniform(-noise, noise, size=pts.shape) * thickness
    return pts, np.asarray(tris, dtype=np.uint32)
