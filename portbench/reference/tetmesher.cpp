// Frozen copy of the repository's native/tetmesher.cpp, the reference mesher of the
// benchmark's plain reference: built by portbench/reference/mesher.py into the checkout's
// build/portbench/tetmesher/, never from the program's build.
//
// Delaunay-based interior tetrahedralizer — the native meshing core.
//
// Role in the framework: the quality step between the Python voxel mesher and a full
// constrained-Delaunay port (the reference ships a TetGen-class CDT at
// src/mesh/Tetrahedralize.cpp; this file is an original implementation, not a port).
//
// Pipeline:
//   1. vertex set = surface vertices (preserved exactly in the output) + an interior
//      lattice seeded interval-aware along all three axes (ray-crossing parity against
//      the surface, grid-bucketed): thin walls below the lattice spacing get
//      mid-thickness seeds instead of starving (the scanned bowl/plate regime)
//   2. incremental Bowyer-Watson Delaunay over a deterministic hash-jittered copy of the
//      points (the jitter resolves exact degeneracies: cospherical grid corners etc.);
//      point location by tetrahedron walk from the last insertion
//   3. conforming boundary recovery + optional Delaunay quality refinement
//   4. sliver REPAIR (circumcenter / longest-edge-midpoint insertion rounds), so flat
//      interior tets are excavated rather than dropped (no FEM-domain perforation)
//   5. carve: keep tets whose centroid lies inside the surface (same parity test);
//      anything still flat is dropped as the last resort, with a counter
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <array>
#include <algorithm>
#include <unordered_map>
#include <random>
#include <functional>

namespace {

using u32 = uint32_t;
using u64 = uint64_t;

struct V3 {
    double x, y, z;
    V3 operator-(const V3 &o) const { return {x - o.x, y - o.y, z - o.z}; }
    V3 operator+(const V3 &o) const { return {x + o.x, y + o.y, z + o.z}; }
    V3 operator*(double s) const { return {x * s, y * s, z * s}; }
};
inline double dot(const V3 &a, const V3 &b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(const V3 &a, const V3 &b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double norm2(const V3 &a) { return dot(a, a); }

// Robust predicates: evaluate in double with a conservative magnitude filter; when the
// result is smaller than the rounding-error bound, re-evaluate in __float128 (113-bit
// mantissa — differences of doubles are exact there, products carry ~2^-113 relative
// error, far below any filterable scale). The role Shewchuk's adaptive predicates play
// in the reference's TetGen path, with quad arithmetic standing in for the expansion
// arithmetic; the deterministic jitter remains the final tie-breaker for the
// (astronomically unlikely) residual ties.
typedef __float128 quad;
struct Q3 {
    quad x, y, z;
    Q3(const V3 &v) : x(v.x), y(v.y), z(v.z) {}
};

inline quad orient3d_q(const V3 &a, const V3 &b, const V3 &c, const V3 &d) {
    const Q3 qa(a), qb(b), qc(c), qd(d);
    const quad bx = qb.x - qa.x, by = qb.y - qa.y, bz = qb.z - qa.z;
    const quad cx = qc.x - qa.x, cy = qc.y - qa.y, cz = qc.z - qa.z;
    const quad dx = qd.x - qa.x, dy = qd.y - qa.y, dz = qd.z - qa.z;
    return dx * (by * cz - bz * cy) + dy * (bz * cx - bx * cz) + dz * (bx * cy - by * cx);
}

inline double orient3d(const V3 &a, const V3 &b, const V3 &c, const V3 &d) {
    // > 0 when d is on the positive side of plane(a, b, c).
    const V3 ab = b - a, ac = c - a, ad = d - a;
    const double t0 = ad.x * (ab.y * ac.z - ab.z * ac.y);
    const double t1 = ad.y * (ab.z * ac.x - ab.x * ac.z);
    const double t2 = ad.z * (ab.x * ac.y - ab.y * ac.x);
    const double det = t0 + t1 + t2;
    const double mag = std::fabs(ad.x) * (std::fabs(ab.y * ac.z) + std::fabs(ab.z * ac.y)) +
                       std::fabs(ad.y) * (std::fabs(ab.z * ac.x) + std::fabs(ab.x * ac.z)) +
                       std::fabs(ad.z) * (std::fabs(ab.x * ac.y) + std::fabs(ab.y * ac.x));
    const double err = 3.3307e-16 * mag;  // ~ (3 + 16 eps) eps, conservative
    if (det > err || det < -err) return det;
    const quad q = orient3d_q(a, b, c, d);
    return q > 0 ? 1.0 : (q < 0 ? -1.0 : 0.0);
}

inline double insphere(const V3 &a, const V3 &b, const V3 &c, const V3 &d, const V3 &p) {
    // > 0 when p is inside the circumsphere of positively-oriented (a, b, c, d).
    const V3 ap = a - p, bp = b - p, cp = c - p, dp = d - p;
    const double aa = norm2(ap), bb = norm2(bp), cc = norm2(cp), dd = norm2(dp);
    const double m[4][4] = {
        {ap.x, ap.y, ap.z, aa},
        {bp.x, bp.y, bp.z, bb},
        {cp.x, cp.y, cp.z, cc},
        {dp.x, dp.y, dp.z, dd},
    };
    // 4x4 determinant by cofactor expansion on the last column.
    auto det3 = [](double a0, double a1, double a2, double b0, double b1, double b2,
                   double c0, double c1, double c2) {
        return a0 * (b1 * c2 - b2 * c1) - a1 * (b0 * c2 - b2 * c0) + a2 * (b0 * c1 - b1 * c0);
    };
    double det = 0;
    det -= m[0][3] * det3(m[1][0], m[1][1], m[1][2], m[2][0], m[2][1], m[2][2], m[3][0], m[3][1], m[3][2]);
    det += m[1][3] * det3(m[0][0], m[0][1], m[0][2], m[2][0], m[2][1], m[2][2], m[3][0], m[3][1], m[3][2]);
    det -= m[2][3] * det3(m[0][0], m[0][1], m[0][2], m[1][0], m[1][1], m[1][2], m[3][0], m[3][1], m[3][2]);
    det += m[3][3] * det3(m[0][0], m[0][1], m[0][2], m[1][0], m[1][1], m[1][2], m[2][0], m[2][1], m[2][2]);
    // Magnitude filter: same expansion with every product taken in absolute value.
    auto det3abs = [](double a0, double a1, double a2, double b0, double b1, double b2,
                      double c0, double c1, double c2) {
        return std::fabs(a0) * (std::fabs(b1 * c2) + std::fabs(b2 * c1)) +
               std::fabs(a1) * (std::fabs(b0 * c2) + std::fabs(b2 * c0)) +
               std::fabs(a2) * (std::fabs(b0 * c1) + std::fabs(b1 * c0));
    };
    double mag = 0;
    mag += std::fabs(m[0][3]) * det3abs(m[1][0], m[1][1], m[1][2], m[2][0], m[2][1], m[2][2], m[3][0], m[3][1], m[3][2]);
    mag += std::fabs(m[1][3]) * det3abs(m[0][0], m[0][1], m[0][2], m[2][0], m[2][1], m[2][2], m[3][0], m[3][1], m[3][2]);
    mag += std::fabs(m[2][3]) * det3abs(m[0][0], m[0][1], m[0][2], m[1][0], m[1][1], m[1][2], m[3][0], m[3][1], m[3][2]);
    mag += std::fabs(m[3][3]) * det3abs(m[0][0], m[0][1], m[0][2], m[1][0], m[1][1], m[1][2], m[2][0], m[2][1], m[2][2]);
    const double err = 1.2e-15 * mag;  // conservative rounding bound for the expansion
    if (det > err || det < -err) {
        // Negative for p strictly inside the circumsphere of a positively-oriented
        // tet; negate so the conventional "> 0 means inside" holds.
        return -det;
    }
    // Filter failed: re-evaluate in quad from the original coordinates.
    const Q3 qa(a), qb(b), qc(c), qd(d), qp(p);
    const quad ax = qa.x - qp.x, ay = qa.y - qp.y, az = qa.z - qp.z;
    const quad bx = qb.x - qp.x, by = qb.y - qp.y, bz = qb.z - qp.z;
    const quad cx = qc.x - qp.x, cy = qc.y - qp.y, cz = qc.z - qp.z;
    const quad dx = qd.x - qp.x, dy = qd.y - qp.y, dz = qd.z - qp.z;
    const quad aq = ax * ax + ay * ay + az * az, bq = bx * bx + by * by + bz * bz;
    const quad cq = cx * cx + cy * cy + cz * cz, dq = dx * dx + dy * dy + dz * dz;
    auto det3q = [](quad a0, quad a1, quad a2, quad b0, quad b1, quad b2,
                    quad c0, quad c1, quad c2) {
        return a0 * (b1 * c2 - b2 * c1) - a1 * (b0 * c2 - b2 * c0) + a2 * (b0 * c1 - b1 * c0);
    };
    quad qdet = 0;
    qdet -= aq * det3q(bx, by, bz, cx, cy, cz, dx, dy, dz);
    qdet += bq * det3q(ax, ay, az, cx, cy, cz, dx, dy, dz);
    qdet -= cq * det3q(ax, ay, az, bx, by, bz, dx, dy, dz);
    qdet += dq * det3q(ax, ay, az, bx, by, bz, cx, cy, cz);
    return qdet < 0 ? 1.0 : (qdet > 0 ? -1.0 : 0.0);
}

inline u64 splitmix(u64 &s) {
    u64 z = (s += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
}

// ---- parity-based inside test with a yz bucket grid over the triangles ----

struct InsideTester {
    const double *pts;       // surface points (n, 3)
    const u32 *tris;         // (m, 3)
    u64 ntris;
    double ylo, zlo, cell;   // bucket grid origin + size
    int ny, nz;
    std::vector<std::vector<u32>> buckets;

    void build(const double *p, u64 npts, const u32 *t, u64 m) {
        pts = p;
        tris = t;
        ntris = m;
        double yhi = -1e300, zhi = -1e300;
        ylo = 1e300;
        zlo = 1e300;
        for (u64 i = 0; i < npts; ++i) {
            ylo = std::min(ylo, p[3 * i + 1]);
            yhi = std::max(yhi, p[3 * i + 1]);
            zlo = std::min(zlo, p[3 * i + 2]);
            zhi = std::max(zhi, p[3 * i + 2]);
        }
        const int target = std::max(1, (int)std::sqrt((double)m));
        ny = std::min(256, target);
        nz = std::min(256, target);
        cell = std::max({(yhi - ylo) / ny, (zhi - zlo) / nz, 1e-12});
        ny = std::max(1, (int)std::ceil((yhi - ylo) / cell));
        nz = std::max(1, (int)std::ceil((zhi - zlo) / cell));
        buckets.assign((size_t)ny * nz, {});
        for (u64 ti = 0; ti < m; ++ti) {
            double by0 = 1e300, by1 = -1e300, bz0 = 1e300, bz1 = -1e300;
            for (int k = 0; k < 3; ++k) {
                const double *v = &p[3 * t[3 * ti + k]];
                by0 = std::min(by0, v[1]);
                by1 = std::max(by1, v[1]);
                bz0 = std::min(bz0, v[2]);
                bz1 = std::max(bz1, v[2]);
            }
            int iy0 = std::clamp((int)((by0 - ylo) / cell), 0, ny - 1);
            int iy1 = std::clamp((int)((by1 - ylo) / cell), 0, ny - 1);
            int iz0 = std::clamp((int)((bz0 - zlo) / cell), 0, nz - 1);
            int iz1 = std::clamp((int)((bz1 - zlo) / cell), 0, nz - 1);
            for (int iy = iy0; iy <= iy1; ++iy)
                for (int iz = iz0; iz <= iz1; ++iz) buckets[(size_t)iy * nz + iz].push_back((u32)ti);
        }
    }

    bool inside(double qx, double qy, double qz) const {
        // Count crossings of the +x ray; jitter handled by the caller's point choice.
        int iy = std::clamp((int)((qy - ylo) / cell), 0, ny - 1);
        int iz = std::clamp((int)((qz - zlo) / cell), 0, nz - 1);
        int count = 0;
        for (u32 ti : buckets[(size_t)iy * nz + iz]) {
            const double *a = &pts[3 * tris[3 * ti + 0]];
            const double *b = &pts[3 * tris[3 * ti + 1]];
            const double *c = &pts[3 * tris[3 * ti + 2]];
            const double d1y = b[1] - a[1], d1z = b[2] - a[2];
            const double d2y = c[1] - a[1], d2z = c[2] - a[2];
            const double den = d1y * d2z - d2y * d1z;
            if (std::fabs(den) < 1e-30) continue;
            const double py = qy - a[1], pz = qz - a[2];
            const double u = (py * d2z - pz * d2y) / den;
            const double w = (pz * d1y - py * d1z) / den;
            if (u < 0 || w < 0 || u + w > 1) continue;
            const double xhit = a[0] + u * (b[0] - a[0]) + w * (c[0] - a[0]);
            if (xhit > qx) ++count;
        }
        return (count & 1) == 1;
    }

    // All crossing coordinates of the full +-x line at (qy, qz), sorted ascending.
    // Consecutive pairs bound the inside intervals of the line (odd counts mean the
    // ray grazed a degeneracy; callers skip those lines — the grid jitter makes them
    // rare). This powers interval-aware lattice seeding: thin walls whose thickness is
    // below the lattice spacing never contain a grid point, but every inside interval
    // is visible on some axis line and gets a mid-interval seed instead (the
    // lattice-starvation fix for scanned thin shells: bowls, plates, goblets).
    void line_crossings(double qy, double qz, std::vector<double> &xs) const {
        xs.clear();
        int iy = std::clamp((int)((qy - ylo) / cell), 0, ny - 1);
        int iz = std::clamp((int)((qz - zlo) / cell), 0, nz - 1);
        for (u32 ti : buckets[(size_t)iy * nz + iz]) {
            const double *a = &pts[3 * tris[3 * ti + 0]];
            const double *b = &pts[3 * tris[3 * ti + 1]];
            const double *c = &pts[3 * tris[3 * ti + 2]];
            const double d1y = b[1] - a[1], d1z = b[2] - a[2];
            const double d2y = c[1] - a[1], d2z = c[2] - a[2];
            const double den = d1y * d2z - d2y * d1z;
            if (std::fabs(den) < 1e-30) continue;
            const double py = qy - a[1], pz = qz - a[2];
            const double u = (py * d2z - pz * d2y) / den;
            const double w = (pz * d1y - py * d1z) / den;
            if (u < 0 || w < 0 || u + w > 1) continue;
            xs.push_back(a[0] + u * (b[0] - a[0]) + w * (c[0] - a[0]));
        }
        std::sort(xs.begin(), xs.end());
    }
};

// ---- Bowyer-Watson incremental Delaunay ----

struct Tet {
    u32 v[4];       // vertex ids (includes 4 virtual bounding-tet ids at the start)
    int nbr[4];     // neighbor tet across the face opposite v[k]; -1 = hull
    bool alive = true;
};

struct Delaunay {
    std::vector<V3> pts;       // jittered working coordinates
    std::vector<Tet> tets;
    int last_alive = 0;

    static constexpr int FACE[4][3] = {{1, 2, 3}, {0, 3, 2}, {0, 1, 3}, {0, 2, 1}};

    void init_bounding(const V3 &lo, const V3 &hi) {
        const V3 c = (lo + hi) * 0.5;
        const double r = 20.0 * std::sqrt(norm2(hi - lo)) + 1.0;
        pts.push_back({c.x - 2 * r, c.y - r, c.z - r});
        pts.push_back({c.x + 2 * r, c.y - r, c.z - r});
        pts.push_back({c.x, c.y + 2 * r, c.z - r});
        pts.push_back({c.x, c.y, c.z + 2 * r});
        Tet t0;
        t0.v[0] = 0; t0.v[1] = 1; t0.v[2] = 2; t0.v[3] = 3;
        if (orient3d(pts[0], pts[1], pts[2], pts[3]) < 0) std::swap(t0.v[0], t0.v[1]);
        t0.nbr[0] = t0.nbr[1] = t0.nbr[2] = t0.nbr[3] = -1;
        tets.push_back(t0);
    }

    int locate(const V3 &p) {
        // Remembering stochastic walk from the last alive tet.
        int cur = last_alive;
        if (!tets[cur].alive)
            for (int i = (int)tets.size() - 1; i >= 0; --i)
                if (tets[i].alive) { cur = i; break; }
        for (int step = 0; step < (int)tets.size() + 8; ++step) {
            const Tet &t = tets[cur];
            int next = -2;
            for (int f = 0; f < 4; ++f) {
                const V3 &a = pts[t.v[FACE[f][0]]];
                const V3 &b = pts[t.v[FACE[f][1]]];
                const V3 &c = pts[t.v[FACE[f][2]]];
                // With this FACE table the opposite vertex lies on the negative side of
                // the face plane, so p is outside through face f when orient3d > 0.
                if (orient3d(a, b, c, p) > 0) { next = t.nbr[f]; break; }
            }
            if (next == -2) return cur;  // inside
            if (next == -1) return cur;  // walked to the hull; cur is the closest
            cur = next;
        }
        return cur;
    }

    void insert(u32 pid) {
        const V3 &p = pts[pid];
        const int seed = locate(p);
        // Grow the cavity of tets whose circumsphere contains p.
        std::vector<int> cavity;
        std::vector<int> stack{seed};
        std::vector<char> mark(tets.size(), 0);
        mark[seed] = 1;
        while (!stack.empty()) {
            int ti = stack.back();
            stack.pop_back();
            Tet &t = tets[ti];
            if (!t.alive) continue;
            if (insphere(pts[t.v[0]], pts[t.v[1]], pts[t.v[2]], pts[t.v[3]], p) <= 0 && ti != seed)
                continue;
            cavity.push_back(ti);
            for (int f = 0; f < 4; ++f) {
                int nb = t.nbr[f];
                if (nb >= 0 && !mark[nb]) { mark[nb] = 1; stack.push_back(nb); }
            }
        }
        // Boundary faces of the cavity -> new tets.
        std::vector<char> in_cav(tets.size(), 0);
        for (int ti : cavity) in_cav[ti] = 1;
        struct NewTet { u32 a, b, c; int outside; int from; };
        std::vector<NewTet> faces;
        for (int ti : cavity) {
            Tet &t = tets[ti];
            for (int f = 0; f < 4; ++f) {
                int nb = t.nbr[f];
                if (nb >= 0 && in_cav[nb]) continue;
                faces.push_back({t.v[FACE[f][0]], t.v[FACE[f][1]], t.v[FACE[f][2]], nb, ti});
            }
            t.alive = false;
        }
        // Create one tet per boundary face (p + face), oriented positively.
        std::unordered_map<u64, std::pair<int, int>> half;  // edge key -> (tet, face slot)
        half.reserve(faces.size() * 3);
        int first_new = (int)tets.size();
        for (auto &fc : faces) {
            Tet nt;
            nt.v[0] = pid; nt.v[1] = fc.a; nt.v[2] = fc.b; nt.v[3] = fc.c;
            if (orient3d(pts[nt.v[0]], pts[nt.v[1]], pts[nt.v[2]], pts[nt.v[3]]) < 0)
                std::swap(nt.v[2], nt.v[3]);
            nt.nbr[0] = fc.outside;   // face opposite p = the old outside neighbor
            nt.nbr[1] = nt.nbr[2] = nt.nbr[3] = -1;
            int ti = (int)tets.size();
            tets.push_back(nt);
            // Fix the back pointer on the face the outside tet shared with fc.from.
            if (fc.outside >= 0) {
                Tet &o = tets[fc.outside];
                for (int f = 0; f < 4; ++f) {
                    if (o.nbr[f] == fc.from) { o.nbr[f] = ti; break; }
                }
            }
        }
        // Stitch new tets to each other across the edges of the cavity boundary (faces
        // sharing an edge of the old boundary share the new edge (p, edge)).
        for (int ti = first_new; ti < (int)tets.size(); ++ti) {
            Tet &t = tets[ti];
            // Faces 1..3 contain p; the face opposite v[k] (k>=1) has vertices
            // {p} U (face verts minus v[k]) -> key on the non-p pair.
            for (int k = 1; k < 4; ++k) {
                u32 a = t.v[(k == 1) ? 2 : 1];
                u32 b = t.v[(k == 3) ? 2 : 3];
                if (a > b) std::swap(a, b);
                u64 key = ((u64)a << 32) | b;
                auto it = half.find(key);
                if (it == half.end()) half[key] = {ti, k};
                else {
                    t.nbr[k] = it->second.first;
                    tets[it->second.first].nbr[it->second.second] = ti;
                }
            }
        }
        last_alive = first_new;
    }
};

}  // namespace

extern "C" {

// Returns 0 on success. Caller passes output buffers sized via tetmesh_count upper bounds;
// the two-call protocol: first call with out_tets == nullptr fills *out_ntets with the
// exact count, second call copies.
int tetmesh_delaunay(
    const double *points, u64 npoints,
    const u32 *tris, u64 ntris,
    double lattice_h,          // interior lattice spacing; <= 0 picks bbox/16
    double quality_bound,      // circumradius/shortest-edge refinement bound; <= 0 off
    double *work_scale,        // out: jitter scale used (diagnostics)
    u32 *out_tets,             // (max_tets, 4) or nullptr for counting
    u64 *inout_ntets,          // in: capacity; out: count
    double *out_points,        // (npoints + n_lattice, 3) or nullptr
    u64 *inout_npoints,        // in: capacity; out: count
    double *out_profile        // (10,) stage counters or nullptr (tetra::Profile analog:
                               // lattice, recovery Steiner, refine points, recovery
                               // rounds, refine passes, carved-out tets, slivers
                               // dropped, kept, thin-wall seeds, sliver repairs)
) {
    double prof_counts[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    if (npoints < 4 || ntris < 4) return 1;
    // Bounds.
    V3 lo{1e300, 1e300, 1e300}, hi{-1e300, -1e300, -1e300};
    for (u64 i = 0; i < npoints; ++i) {
        lo.x = std::min(lo.x, points[3 * i]);
        lo.y = std::min(lo.y, points[3 * i + 1]);
        lo.z = std::min(lo.z, points[3 * i + 2]);
        hi.x = std::max(hi.x, points[3 * i]);
        hi.y = std::max(hi.y, points[3 * i + 1]);
        hi.z = std::max(hi.z, points[3 * i + 2]);
    }
    const double diag = std::sqrt(norm2(hi - lo));
    if (!(diag > 0)) return 2;
    double h = lattice_h > 0 ? lattice_h : std::max({hi.x - lo.x, hi.y - lo.y, hi.z - lo.z}) / 16.0;
    // BCC interior seeding (isosurface-stuffing style): the cubic lattice ALONE is
    // maximally co-spherical — every cell's 8 corners lie on one sphere, so the
    // Bowyer-Watson tie-breaks emit near-zero-volume slivers at whatever scale the
    // degeneracy jitter is (measured on the quickstart torus: element quality
    // vol/lmax^3 down to 1e-6, which explodes the FEM pencil's conditioning and
    // breaks the f32 inner solve). Adding the body-centered sublattice makes the
    // Delaunay the classic BCC disphenoid mesh: unique, tie-free, uniform quality
    // ~3e-2. The spacing is scaled by 2^(1/3) so the POINT DENSITY (hence dof count
    // and element size) matches the caller's requested cubic spacing.
    h *= 1.2599210498948732;

    InsideTester inside;
    inside.build(points, npoints, tris, ntris);

    // Vertex set: surface points first (ids preserved), then interior lattice points.
    // With quality refinement on, lattice points hugging the skin are dropped (their
    // clearance probed with parity tests): the surface/lattice interface is where the
    // sliver tets form, and spacing the interior away from the skin prevents them at
    // the source (the biggest single quality lever for lattice-seeded Delaunay).
    std::vector<double> all(points, points + 3 * npoints);
    const double jy = 0.12345e-4 * h, jz = 0.54321e-4 * h;  // ray-degeneracy nudge
    // Clearance runs in EVERY mode (round 5; it was quality-only before): lattice
    // points hugging the skin both seed sliver tets AND block constraint faces,
    // and on irregular (scan/iso-surface-class) skins the blocked faces drove the
    // recovery's bisection cascade to ~85k Steiner points on a 4k-vertex blob.
    // Thin walls stay seeded: intervals the clearance starves fall through to the
    // midpoint fallback below.
    const double clearance = 0.45 * h;
    auto has_clearance = [&](double x, double y, double z) {
        if (clearance <= 0) return true;
        static const double D[14][3] = {
            {1, 0, 0}, {-1, 0, 0}, {0, 1, 0}, {0, -1, 0}, {0, 0, 1}, {0, 0, -1},
            {0.5774, 0.5774, 0.5774}, {-0.5774, 0.5774, 0.5774},
            {0.5774, -0.5774, 0.5774}, {0.5774, 0.5774, -0.5774},
            {-0.5774, -0.5774, 0.5774}, {-0.5774, 0.5774, -0.5774},
            {0.5774, -0.5774, -0.5774}, {-0.5774, -0.5774, -0.5774}};
        for (const auto &d : D)
            if (!inside.inside(x + clearance * d[0], y + jy + clearance * d[1],
                               z + jz + clearance * d[2]))
                return false;
        return true;
    };
    // Interval-aware lattice: for every grid line along every axis, compute the inside
    // intervals once (line_crossings) and place the regular grid points that fall in
    // them; an interval thinner than the spacing that caught NO grid point gets its
    // midpoint instead. This is the thin-shell fix: a 2-5%-thickness wall (the
    // RealImpact bowl/plate regime) has no room for lattice points at h, which starved
    // the interior entirely and left the FEM domain quality to skin-skin slivers —
    // now every wall gets a mid-thickness sheet of seeds from whichever axis crosses
    // it thinly. Cross-axis near-duplicates are suppressed with a spatial hash.
    u64 thin_seeds = 0;
    {
        // Axis permutations: tester t_a casts lines along world axis a; its local
        // frame is (a, a+1, a+2) cyclic.
        std::vector<double> perm1(3 * npoints), perm2(3 * npoints);
        for (u64 i = 0; i < npoints; ++i) {
            perm1[3 * i + 0] = points[3 * i + 1];  // axis 1 (y) becomes the line axis
            perm1[3 * i + 1] = points[3 * i + 2];
            perm1[3 * i + 2] = points[3 * i + 0];
            perm2[3 * i + 0] = points[3 * i + 2];  // axis 2 (z) becomes the line axis
            perm2[3 * i + 1] = points[3 * i + 0];
            perm2[3 * i + 2] = points[3 * i + 1];
        }
        InsideTester inside_y, inside_z;
        inside_y.build(perm1.data(), npoints, tris, ntris);
        inside_z.build(perm2.data(), npoints, tris, ntris);
        const InsideTester *testers[3] = {&inside, &inside_y, &inside_z};
        const double los[3] = {lo.x, lo.y, lo.z}, his[3] = {hi.x, hi.y, hi.z};

        // Dedup hash over all accepted lattice/thin points, cell size h.
        std::unordered_map<u64, std::vector<V3>> occ;
        auto cell_of = [&](const V3 &p) {
            const long cx = (long)std::floor((p.x - lo.x) / h);
            const long cy = (long)std::floor((p.y - lo.y) / h);
            const long cz = (long)std::floor((p.z - lo.z) / h);
            return ((u64)(cx & 0x1fffff) << 42) | ((u64)(cy & 0x1fffff) << 21) |
                   (u64)(cz & 0x1fffff);
        };
        auto too_close = [&](const V3 &p, double r2) {
            for (int dx = -1; dx <= 1; ++dx)
                for (int dy = -1; dy <= 1; ++dy)
                    for (int dz = -1; dz <= 1; ++dz) {
                        const V3 q{p.x + dx * h, p.y + dy * h, p.z + dz * h};
                        auto it = occ.find(cell_of(q));
                        if (it == occ.end()) continue;
                        for (const V3 &o : it->second)
                            if (norm2(p - o) < r2) return true;
                    }
            return false;
        };
        const double lattice_jitter = 4e-4;  // lifts grid-degeneracy without disturbing conformity (see sweep in round-2 notes)
        u64 seed_seed = 0xfeedfacecafe1234ull;
        auto accept = [&](const V3 &p, double jmag) {
            // Deterministic real jitter: interior seeds on grid lines/planes would
            // otherwise create exactly-coplanar quadruples that survive into the
            // OUTPUT mesh as zero-volume elements (the working-copy jitter only
            // untangles the Delaunay, not the emitted geometry).
            V3 q = p;
            q.x += ((double)(splitmix(seed_seed) >> 11) / 9007199254740992.0 - 0.5) * jmag;
            q.y += ((double)(splitmix(seed_seed) >> 11) / 9007199254740992.0 - 0.5) * jmag;
            q.z += ((double)(splitmix(seed_seed) >> 11) / 9007199254740992.0 - 0.5) * jmag;
            occ[cell_of(q)].push_back(q);
            all.push_back(q.x);
            all.push_back(q.y);
            all.push_back(q.z);
        };

        std::vector<double> xs;
        for (int pass = 0; pass < 4; ++pass) {
            // Passes 0-1: the axis-0 grid scan for the two BCC sublattices (corner
            // phase 0, body-center phase h/2 on all three axes). Passes 2-3: the y/z
            // thin-interval hunts (phase 0 only — thin seeds are clearance-gated and
            // deduped, so one phase suffices).
            const int axis = pass < 2 ? 0 : pass - 1;
            const double x_phase = pass == 1 ? 0.5 * h : 0.0;
            const int u_ax = (axis + 1) % 3, v_ax = (axis + 2) % 3;
            for (double u = los[u_ax] + 0.5 * h + x_phase; u < his[u_ax]; u += h)
                for (double v = los[v_ax] + 0.5 * h + x_phase; v < his[v_ax]; v += h) {
                    testers[axis]->line_crossings(u + jy, v + jz, xs);
                    if (xs.size() & 1) continue;  // grazed a degeneracy; skip the line
                    for (size_t k = 0; k + 1 < xs.size(); k += 2) {
                        const double x0 = xs[k], x1 = xs[k + 1];
                        auto world = [&](double t) {
                            V3 p;
                            double c[3];
                            c[axis] = t;
                            c[u_ax] = u;
                            c[v_ax] = v;
                            p = {c[0], c[1], c[2]};
                            return p;
                        };
                        bool placed = false;
                        if (axis == 0) {
                            // The regular grid rides the x lines only (identical point
                            // set to a full 3-D grid scan); y/z lines contribute
                            // thin-interval seeds alone. Each x line belongs to the
                            // corner sublattice (u,v on the .5h grid) or, when the
                            // half-offset lines are scanned below, the body-centered
                            // one — both place points at their sublattice's x phase.
                            const double start = los[0] + 0.5 * h + x_phase;
                            double g = start + std::ceil((x0 - start) / h) * h;
                            for (; g < x1; g += h) {
                                const V3 p = world(g);
                                if (has_clearance(p.x, p.y, p.z)) {
                                    accept(p, lattice_jitter * h);
                                    placed = true;
                                }
                            }
                        } else {
                            // y/z lines only hunt starved thin intervals: a grid
                            // coordinate inside the interval means the axis-0 pass
                            // already considered the 3-D grid point here — it stands
                            // unless the clearance rule rejected it (in a genuinely
                            // thin wall the clearance ball never fits, so the probe
                            // re-checks it).
                            const double start = los[axis] + 0.5 * h;
                            double g = start + std::ceil((x0 - start) / h) * h;
                            if (g < x1) {
                                const V3 p = world(g);
                                placed = has_clearance(p.x, p.y, p.z);
                            }
                        }
                        // Starved-interval fallback: thin walls (interval < h) AND
                        // intervals whose every grid point failed the clearance gate
                        // (bumpy skins reject laterally) get a mid-interval seed, so
                        // no inside run of the line goes entirely unseeded.
                        if (!placed && (x1 - x0) > 1e-9 * diag &&
                            thin_seeds < 500000) {
                            const V3 mid = world(0.5 * (x0 + x1));
                            const double guard = 0.35 * std::min(h, x1 - x0);
                            if (!too_close(mid, guard * guard)) {
                                accept(mid, std::min(lattice_jitter * h, 0.1 * (x1 - x0)));
                                ++thin_seeds;
                            }
                        }
                    }
                }
        }
    }
    const u64 nall = all.size() / 3;
    prof_counts[0] = (double)(nall - npoints);  // interior lattice points
    prof_counts[8] = (double)thin_seeds;  // thin-interval mid-wall seeds (subset)

    // Jittered working copy (deterministic): resolves cospherical/coplanar degeneracies.
    const double jitter = 1e-7 * diag;
    if (work_scale) *work_scale = jitter;
    Delaunay dl;
    dl.pts.reserve(nall + 4);
    dl.init_bounding(lo, hi);
    u64 seed = 0x51a3c0ffee123457ull;
    for (u64 i = 0; i < nall; ++i) {
        const double jx = ((double)(splitmix(seed) >> 11) / 9007199254740992.0 - 0.5) * jitter;
        const double jy2 = ((double)(splitmix(seed) >> 11) / 9007199254740992.0 - 0.5) * jitter;
        const double jz2 = ((double)(splitmix(seed) >> 11) / 9007199254740992.0 - 0.5) * jitter;
        dl.pts.push_back({all[3 * i] + jx, all[3 * i + 1] + jy2, all[3 * i + 2] + jz2});
    }
    for (u64 i = 0; i < nall; ++i) dl.insert((u32)(4 + i));

    // ---- Boundary recovery (conforming Delaunay with Steiner points) ----
    // Every input surface triangle must appear as a union of triangulation faces, or
    // the carve can cut through the skin. Missing constraint edges get midpoints and
    // missing faces get centroids (TetGen's conforming refinement, simplified); a
    // split constraint is replaced by its sub-triangles and the loop re-checks, a few
    // rounds at most. Steiner points append after the lattice points, so surface
    // vertex ids stay preserved for the caller.
    std::vector<std::array<u32, 3>> constraints(ntris);
    for (u64 i = 0; i < ntris; ++i)
        constraints[i] = {tris[3 * i], tris[3 * i + 1], tris[3 * i + 2]};
    std::unordered_map<u64, u32> edge_steiner;  // sorted edge -> steiner vertex id
    auto ekey = [](u32 a, u32 b) {
        if (a > b) std::swap(a, b);
        return ((u64)a << 32) | b;
    };
    auto add_point = [&](double x, double y, double z) -> u32 {
        u32 id = (u32)(all.size() / 3);
        all.push_back(x); all.push_back(y); all.push_back(z);
        const double jx = ((double)(splitmix(seed) >> 11) / 9007199254740992.0 - 0.5) * jitter;
        const double jy2 = ((double)(splitmix(seed) >> 11) / 9007199254740992.0 - 0.5) * jitter;
        const double jz2 = ((double)(splitmix(seed) >> 11) / 9007199254740992.0 - 0.5) * jitter;
        dl.pts.push_back({x + jx, y + jy2, z + jz2});
        dl.insert(4 + id);
        return id;
    };
    auto recover = [&]() {
        const u64 entry_points = all.size() / 3;  // runaway guard is per-invocation
        for (int round = 0; round < 24; ++round) {
            prof_counts[3] += 1;  // recovery rounds
            // Face and edge sets of the live triangulation (surface-id space).
            std::unordered_map<u64, char> faces;
            std::unordered_map<u64, char> edges;
            faces.reserve(dl.tets.size() * 4);
            edges.reserve(dl.tets.size() * 6);
            const u64 nv = all.size() / 3;
            if (nv >= (1ull << 21)) break;  // face keys pack 3x21 bits
            auto fkey = [](u32 a, u32 b, u32 c) {
                if (a > b) std::swap(a, b);
                if (b > c) std::swap(b, c);
                if (a > b) std::swap(a, b);
                return ((u64)a << 42) | ((u64)b << 21) | c;
            };
            static constexpr int FACE_T[4][3] = {{1, 2, 3}, {0, 3, 2}, {0, 1, 3}, {0, 2, 1}};
            for (const Tet &t : dl.tets) {
                if (!t.alive) continue;
                u32 v[4];
                bool bounding = false;
                for (int k = 0; k < 4; ++k) {
                    if (t.v[k] < 4) { bounding = true; break; }
                    v[k] = t.v[k] - 4;
                }
                if (bounding) continue;
                for (int f = 0; f < 4; ++f)
                    faces[fkey(v[FACE_T[f][0]], v[FACE_T[f][1]], v[FACE_T[f][2]])] = 1;
                for (int i = 0; i < 4; ++i)
                    for (int j = i + 1; j < 4; ++j) edges[ekey(v[i], v[j])] = 1;
            }
            std::vector<std::array<u32, 3>> next;
            next.reserve(constraints.size());
            bool any_split = false;
            for (const auto &c : constraints) {
                if (faces.count(fkey(c[0], c[1], c[2]))) {
                    next.push_back(c);
                    continue;
                }
                // Split the longest missing edge first; with all edges present but the
                // face still flipped away, split at the centroid.
                int split_edge = -1;
                double best = -1;
                for (int k = 0; k < 3; ++k) {
                    u32 a = c[k], b = c[(k + 1) % 3];
                    if (edges.count(ekey(a, b))) continue;
                    const V3 pa{all[3 * a], all[3 * a + 1], all[3 * a + 2]};
                    const V3 pb{all[3 * b], all[3 * b + 1], all[3 * b + 2]};
                    const double l2 = norm2(pb - pa);
                    if (l2 > best) { best = l2; split_edge = k; }
                }
                any_split = true;
                if (split_edge >= 0) {
                    u32 a = c[split_edge], b = c[(split_edge + 1) % 3];
                    u32 o = c[(split_edge + 2) % 3];
                    auto it = edge_steiner.find(ekey(a, b));
                    u32 m;
                    if (it != edge_steiner.end()) m = it->second;
                    else {
                        m = add_point(0.5 * (all[3 * a] + all[3 * b]),
                                      0.5 * (all[3 * a + 1] + all[3 * b + 1]),
                                      0.5 * (all[3 * a + 2] + all[3 * b + 2]));
                        edge_steiner[ekey(a, b)] = m;
                    }
                    next.push_back({a, m, o});
                    next.push_back({m, b, o});
                } else {
                    const u32 a = c[0], b = c[1], cc = c[2];
                    const u32 g = add_point(
                        (all[3 * a] + all[3 * b] + all[3 * cc]) / 3.0,
                        (all[3 * a + 1] + all[3 * b + 1] + all[3 * cc + 1]) / 3.0,
                        (all[3 * a + 2] + all[3 * b + 2] + all[3 * cc + 2]) / 3.0);
                    next.push_back({a, b, g});
                    next.push_back({b, cc, g});
                    next.push_back({cc, a, g});
                }
            }
            constraints.swap(next);
            if (!any_split) break;
            if (all.size() / 3 > entry_points + 8 * ntris) break;  // runaway guard
        }
    };
    recover();
    prof_counts[1] = (double)(all.size() / 3 - nall);  // recovery Steiner points

    // ---- Quality refinement (Delaunay refinement with circumcenter Steiner points) ----
    // The reference refines to circumradius/shortest-edge <= 2 when requested
    // (Tetrahedralize.h:18-21, refinement at Tetrahedralize.cpp:9528). Interior bad
    // tets get their circumcenter inserted when it falls strictly inside the domain
    // (encroachment near the skin is avoided by the inside test plus a surface-distance
    // margin); boundary recovery re-runs after each pass so the skin stays conforming.
    if (quality_bound > 0) {
        const u64 budget = 3 * (all.size() / 3) + 20000;
        const u64 pre_refine = all.size() / 3;
        for (int pass = 0; pass < 8; ++pass) {
            prof_counts[4] += 1;  // refine passes
            struct BadTet { double ratio; V3 cc; double r; };
            std::vector<BadTet> bad;
            for (const Tet &t : dl.tets) {
                if (!t.alive) continue;
                if (t.v[0] < 4 || t.v[1] < 4 || t.v[2] < 4 || t.v[3] < 4) continue;
                V3 p[4];
                for (int k = 0; k < 4; ++k) {
                    const u32 id = t.v[k] - 4;
                    p[k] = {all[3 * id], all[3 * id + 1], all[3 * id + 2]};
                }
                const V3 cen = (p[0] + p[1] + p[2] + p[3]) * 0.25;
                if (!inside.inside(cen.x, cen.y + jy, cen.z + jz)) continue;
                double lmin2 = 1e300;
                for (int i = 0; i < 4; ++i)
                    for (int j = i + 1; j < 4; ++j)
                        lmin2 = std::min(lmin2, norm2(p[i] - p[j]));
                if (!(lmin2 > 0)) continue;
                // Circumcenter: 2(b-a)·c = |b|^2-|a|^2 for b in {1,2,3} (Cramer).
                const V3 ab = p[1] - p[0], ac = p[2] - p[0], ad = p[3] - p[0];
                const double det = 2.0 * dot(ab, cross(ac, ad));
                const double l2 = std::max({norm2(ab), norm2(ac), norm2(ad)});
                if (std::fabs(det) < 1e-9 * l2 * std::sqrt(l2)) continue;  // near-flat
                const double rb = norm2(ab), rc = norm2(ac), rd = norm2(ad);
                const V3 num = cross(ac, ad) * rb + cross(ad, ab) * rc + cross(ab, ac) * rd;
                const V3 cc = p[0] + num * (1.0 / det);
                const double r = std::sqrt(norm2(cc - p[0]));
                const double ratio = r / std::sqrt(lmin2);
                if (ratio > quality_bound) bad.push_back({ratio, cc, r});
            }
            if (bad.empty()) break;
            std::sort(bad.begin(), bad.end(),
                      [](const BadTet &x, const BadTet &y) { return x.ratio > y.ratio; });
            // Batched insertion goes stale (a kill by an earlier insert leaves later
            // circumcenters floating); enforce spacing between this pass's inserts so
            // stale candidates cannot create near-duplicate vertices and fresh slivers.
            std::vector<std::pair<V3, double>> placed;  // point, exclusion radius^2
            int inserted = 0;
            auto try_place = [&](const V3 &p, double excl2) {
                for (const auto &q : placed)
                    if (norm2(p - q.first) < std::min(excl2, q.second)) return false;
                add_point(p.x, p.y, p.z);
                placed.push_back({p, excl2});
                ++inserted;
                return true;
            };
            for (const BadTet &bt : bad) {
                if (all.size() / 3 >= budget || inserted >= 512) break;
                // Classic Delaunay refinement: the circumcenter, when it stays in the
                // domain with clearance and is not crowded by this pass's earlier
                // inserts. Boundary-offending tets (center outside or hugging the
                // skin) are left to the carve + FEM degenerate filter — interior
                // sinks and edge splits both measurably worsen the skin interface.
                if (bt.r <= 0.25 * diag &&
                    inside.inside(bt.cc.x, bt.cc.y + jy, bt.cc.z + jz) &&
                    has_clearance(bt.cc.x, bt.cc.y, bt.cc.z))
                    try_place(bt.cc, 0.25 * bt.r * bt.r);
            }
            if (!inserted) break;
            recover();
            if (all.size() / 3 >= budget) break;
        }
        prof_counts[2] = (double)(all.size() / 3 - pre_refine);  // refine points
        // Recovery Steiner added during refinement passes counts as recovery too.
    }
    // ---- Sliver repair ----
    // Interior slivers (near-zero volume, legal Delaunay) previously fell straight to
    // the carve's drop filter, perforating the FEM domain (the reference REPAIRS
    // slivers instead: Tetrahedralize.cpp sliver removal around :9528). Repair is the
    // Delaunay-refinement move: the sliver's circumsphere contains its circumcenter,
    // so inserting it excavates the sliver; when the circumcenter escapes the domain
    // (skin-hugging slivers), the longest-edge midpoint stands in. Iterate a few
    // rounds; anything still flat afterwards is dropped (and counted) as before.
    {
        const double flat_eps = 1e-8;  // looser than the carve drop (1e-10): repaired
                                       // meshes should not sit at the drop edge
        const u64 repair_budget = all.size() / 3 + 8192;
        for (int round = 0; round < 5; ++round) {
            struct Flat { V3 cc; double r; V3 mid; double excl2; bool cc_ok; bool mid_ok; };
            std::vector<Flat> flats;
            for (const Tet &t : dl.tets) {
                if (!t.alive) continue;
                if (t.v[0] < 4 || t.v[1] < 4 || t.v[2] < 4 || t.v[3] < 4) continue;
                V3 p[4];
                for (int k = 0; k < 4; ++k) {
                    const u32 id = t.v[k] - 4;
                    p[k] = {all[3 * id], all[3 * id + 1], all[3 * id + 2]};
                }
                const V3 &a = p[0];
                const V3 &b = p[1];
                const V3 &c = p[2];
                const V3 &d = p[3];
                const V3 cen = (a + b + c + d) * 0.25;
                if (!inside.inside(cen.x, cen.y + jy, cen.z + jz)) continue;
                const V3 vs[4] = {a, b, c, d};
                double lmax2 = 0;
                int ei = 0, ej = 1;
                for (int i = 0; i < 4; ++i)
                    for (int j = i + 1; j < 4; ++j) {
                        const double l2 = norm2(vs[i] - vs[j]);
                        if (l2 > lmax2) { lmax2 = l2; ei = i; ej = j; }
                    }
                const V3 ab_ = b - a, ac_ = c - a, ad_ = d - a;
                const double vol6 = dot(ad_, cross(ab_, ac_));
                const double l3 = lmax2 * std::sqrt(lmax2);
                if (std::fabs(vol6) >= flat_eps * l3) continue;
                if (std::fabs(vol6) <= 2e-12 * l3) continue;  // exact-degenerate: harmless drop
                // Circumcenter from the ORIGINAL (unjittered) coordinates.
                const V3 ab = p[1] - p[0], ac = p[2] - p[0], ad = p[3] - p[0];
                const double det = 2.0 * dot(ab, cross(ac, ad));
                const double l2m = std::max({norm2(ab), norm2(ac), norm2(ad)});
                Flat f{};
                f.cc_ok = false;
                f.excl2 = 0.04 * lmax2;  // midpoint spacing guard: 0.2 * longest edge
                if (std::fabs(det) > 1e-14 * l2m * std::sqrt(l2m)) {
                    const double rb = norm2(ab), rc = norm2(ac), rd = norm2(ad);
                    const V3 num =
                        cross(ac, ad) * rb + cross(ad, ab) * rc + cross(ab, ac) * rd;
                    f.cc = p[0] + num * (1.0 / det);
                    f.r = std::sqrt(norm2(f.cc - p[0]));
                    f.cc_ok = f.r <= 0.25 * diag &&
                              inside.inside(f.cc.x, f.cc.y + jy, f.cc.z + jz);
                }
                f.mid = (p[ei] + p[ej]) * 0.5;
                f.mid_ok = inside.inside(f.mid.x, f.mid.y + jy, f.mid.z + jz);
                if (f.cc_ok || f.mid_ok) flats.push_back(f);
            }
            if (flats.empty()) break;
            std::vector<std::pair<V3, double>> placed;
            int inserted = 0;
            auto try_place = [&](const V3 &pp, double excl2) {
                for (const auto &q : placed)
                    if (norm2(pp - q.first) < std::min(excl2, q.second)) return false;
                add_point(pp.x, pp.y, pp.z);
                placed.push_back({pp, excl2});
                ++inserted;
                return true;
            };
            for (const Flat &f : flats) {
                if (all.size() / 3 >= repair_budget || inserted >= 512) break;
                if (f.cc_ok) try_place(f.cc, 0.25 * f.r * f.r);
                else if (f.mid_ok) try_place(f.mid, f.excl2);
            }
            if (!inserted) break;
            prof_counts[9] += (double)inserted;  // sliver repair points
            recover();
        }
    }

    const u64 nfinal = all.size() / 3;

    // Carve + collect: drop bounding-tet incidences, keep interior centroids, drop slivers.
    std::vector<std::array<u32, 4>> keep;
    for (const Tet &t : dl.tets) {
        if (!t.alive) continue;
        if (t.v[0] < 4 || t.v[1] < 4 || t.v[2] < 4 || t.v[3] < 4) continue;
        // Degeneracy must be judged in the ORIGINAL coordinates — the jitter that
        // resolves Delaunay ties can make an exactly-coplanar original quadruple look
        // healthy, and the FEM then receives a zero-volume element.
        V3 o[4];
        for (int k = 0; k < 4; ++k) {
            const u32 id = t.v[k] - 4;
            o[k] = {all[3 * id], all[3 * id + 1], all[3 * id + 2]};
        }
        const V3 &a = o[0];
        const V3 &b = o[1];
        const V3 &c = o[2];
        const V3 &d = o[3];
        const V3 cen = (a + b + c + d) * 0.25;
        if (!inside.inside(cen.x, cen.y + jy, cen.z + jz)) { prof_counts[5] += 1; continue; }
        // Magnitude in plain double: orient3d collapses sub-filter determinants to
        // +-1 (sign semantics), which would silently keep near-degenerate tets the
        // FEM degenerate filter (fem/assembly.py, 1e-12) then drops domain-side.
        const V3 ab_ = b - a, ac_ = c - a, ad_ = d - a;
        const double det_d = dot(ad_, cross(ab_, ac_));
        double lmax2 = 0;
        const V3 vs[4] = {a, b, c, d};
        for (int i = 0; i < 4; ++i)
            for (int j = i + 1; j < 4; ++j) lmax2 = std::max(lmax2, norm2(vs[i] - vs[j]));
        if (std::fabs(det_d) < 2e-12 * lmax2 * std::sqrt(lmax2)) { prof_counts[6] += 1; continue; }  // zero-stiffness flat
        const double vol6 = det_d;
        std::array<u32, 4> out{t.v[0] - 4, t.v[1] - 4, t.v[2] - 4, t.v[3] - 4};
        if (vol6 < 0) std::swap(out[2], out[3]);  // positive orientation
        keep.push_back(out);
    }

    // Keep the largest face-connected component: the flat-tet drops above are zero-
    // measure, but if they formed a membrane the remainder could be disconnected —
    // a disconnected FEM domain shows up as spurious rigid-body modes downstream.
    if (!keep.empty()) {
        std::unordered_map<u64, std::array<int, 2>> face_owner;
        face_owner.reserve(keep.size() * 4);
        auto fkey2 = [](u32 a, u32 b, u32 c) {
            if (a > b) std::swap(a, b);
            if (b > c) std::swap(b, c);
            if (a > b) std::swap(a, b);
            return ((u64)a << 42) | ((u64)b << 21) | c;
        };
        static constexpr int FT[4][3] = {{1, 2, 3}, {0, 3, 2}, {0, 1, 3}, {0, 2, 1}};
        std::vector<int> parent(keep.size());
        for (size_t i = 0; i < keep.size(); ++i) parent[i] = (int)i;
        std::function<int(int)> find = [&](int x) {
            while (parent[x] != x) x = parent[x] = parent[parent[x]];
            return x;
        };
        for (size_t i = 0; i < keep.size(); ++i)
            for (int f = 0; f < 4; ++f) {
                const u64 k = fkey2(keep[i][FT[f][0]], keep[i][FT[f][1]], keep[i][FT[f][2]]);
                auto it = face_owner.find(k);
                if (it == face_owner.end()) face_owner[k] = {(int)i, -1};
                else if (it->second[1] < 0) {
                    it->second[1] = (int)i;
                    parent[find((int)i)] = find(it->second[0]);
                }
            }
        std::unordered_map<int, u64> comp_size;
        for (size_t i = 0; i < keep.size(); ++i) comp_size[find((int)i)] += 1;
        int best = -1;
        u64 best_n = 0;
        for (const auto &kv : comp_size)
            if (kv.second > best_n) { best_n = kv.second; best = kv.first; }
        if (best_n < keep.size()) {
            std::vector<std::array<u32, 4>> main_comp;
            main_comp.reserve(best_n);
            for (size_t i = 0; i < keep.size(); ++i)
                if (find((int)i) == best) main_comp.push_back(keep[i]);
            prof_counts[5] += (double)(keep.size() - main_comp.size());  // carved w/ islands
            keep.swap(main_comp);
        }
    }

    prof_counts[7] = (double)keep.size();
    if (out_profile) std::memcpy(out_profile, prof_counts, sizeof(prof_counts));
    if (!out_tets) {
        *inout_ntets = keep.size();
        *inout_npoints = nfinal;
        return 0;
    }
    if (*inout_ntets < keep.size() || *inout_npoints < nfinal) return 3;
    std::memcpy(out_tets, keep.data(), keep.size() * 4 * sizeof(u32));
    std::memcpy(out_points, all.data(), all.size() * sizeof(double));
    *inout_ntets = keep.size();
    *inout_npoints = nfinal;
    return 0;
}

}  // extern "C"
