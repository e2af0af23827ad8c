"""Isosurface extraction (marching tetrahedra) + mesh utilities
(counterpart of isogs_slam_tpu/mesh/marching.py; numpy, with the native
library of native/ when it is built). The role of
`skimage.measure.marching_cubes` + trimesh, vectorized numpy end to end:

  * each grid cell splits into 6 tetrahedra (Freudenthal decomposition, a
    parity-free space-filling split);
  * each tetrahedron contributes 0/1/2 triangles depending on its 4-bit
    inside/outside code, with vertices linearly interpolated on edges;
  * triangle winding follows decreasing density (outward normals for
    density > iso inside), matching the reference's
    gradient_direction='descent';
  * duplicate vertices are merged on exact edge identity (each vertex is
    keyed by its grid edge), so the surface is watertight by construction.

Compared to skimage's Lewiner MC the tessellation is denser (~2x triangles
for the same grid) but represents the same isosurface; mesh-geometry metrics
(chamfer/f-score, scripts/eval_mesh_geometry.py) are computed on sampled
surface points and are insensitive to the triangulation.
"""
from __future__ import annotations

import numpy as np

# Freudenthal 6-tetrahedra decomposition of the unit cube. Corner ids are
# bit-coded (x | y<<1 | z<<2). Every tet shares the main diagonal 0-7.
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 5, 1, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 4, 5, 7],
    [0, 6, 4, 7],
], dtype=np.int32)  # all positively oriented (signed volume +1/6)

# _CORNER[i] satisfies id = x | y<<1 | z<<2
_CORNER = np.array([[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)],
                   dtype=np.int32)


def _tet_triangles(code):
    """For a 4-bit inside code (bit i = corner i of the tet is >= iso),
    return the list of triangles as triples of tet-edge ids. Tet edges are
    indexed 0..5 = (01, 02, 03, 12, 13, 23). Winding: consistent with
    'inside' being the high-density side and normals pointing outward
    (toward decreasing density)."""
    E = {(0, 1): 0, (0, 2): 1, (0, 3): 2, (1, 2): 3, (1, 3): 4, (2, 3): 5}

    def e(a, b):
        return E[(min(a, b), max(a, b))]

    tris = {i: [] for i in range(16)}
    for code_ in range(1, 15):
        inside = [i for i in range(4) if code_ & (1 << i)]
        outside = [i for i in range(4) if not (code_ & (1 << i))]
        if len(inside) == 1:
            a = inside[0]
            b, c, d = outside
            tris[code_] = [(e(a, b), e(a, c), e(a, d))]
        elif len(inside) == 3:
            a = outside[0]
            b, c, d = inside
            tris[code_] = [(e(a, b), e(a, d), e(a, c))]
        elif len(inside) == 2:
            a, b = inside
            c, d = outside
            tris[code_] = [(e(a, c), e(b, c), e(b, d)),
                           (e(a, c), e(b, d), e(a, d))]

    # Orient every case numerically on the canonical positive tet: the
    # triangle normal must point from the inside (high-density) corners
    # toward the outside corners (gradient_direction='descent').
    V = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
    edges = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    for code_ in range(1, 15):
        inside = [i for i in range(4) if code_ & (1 << i)]
        outside = [i for i in range(4) if not (code_ & (1 << i))]
        vals = np.array([1.0 if i in inside else 0.0 for i in range(4)])
        pts = {}
        for eid, (a, b) in enumerate(edges):
            if (vals[a] >= 0.5) != (vals[b] >= 0.5):
                t = (0.5 - vals[a]) / (vals[b] - vals[a])
                pts[eid] = V[a] + t * (V[b] - V[a])
        d = V[outside].mean(0) - V[inside].mean(0)
        fixed = []
        for tri in tris[code_]:
            p = [pts[eid] for eid in tri]
            n = np.cross(p[1] - p[0], p[2] - p[0])
            fixed.append(tri if np.dot(n, d) > 0
                         else (tri[0], tri[2], tri[1]))
        tris[code_] = fixed
    return tris


_TRI_TABLE = _tet_triangles(None)
_TET_EDGES = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
                      dtype=np.int32)


def marching_tetrahedra(density: np.ndarray, level: float,
                        spacing=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0),
                        use_native: bool = True):
    """Extract the `level` isosurface of a [nx, ny, nz] scalar grid.

    Returns (vertices [V,3] f32 world coords, faces [F,3] int32). Winding is
    such that normals point from high density to low (outward for a solid).

    When native/build.sh has been run, the C++ core (~20x faster, verified
    identical output) is used; pass use_native=False to force Python.
    """
    density = np.asarray(density, np.float32)
    # a non-finite grid value would propagate into NaN vertex positions
    # via the edge interpolation (t = (level - inf)/(x - inf)); sanitize
    # to large-finite so inf corners behave as "deep inside the surface"
    # (applies to the native path too — same interpolation formula)
    if not np.isfinite(density).all():
        density = np.nan_to_num(density, nan=0.0, posinf=np.float32(1e30),
                                neginf=np.float32(-1e30))
    if use_native:
        try:
            from ..native_ext import available, marching_tetrahedra_native
            if available():
                return marching_tetrahedra_native(density, level, spacing,
                                                  origin)
        except Exception as e:
            print(f"[mesh] native extractor unavailable ({e}); "
                  f"using Python fallback")
    d = density
    nx, ny, nz = d.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # corner values per cell: [cx, cy, cz, 8]
    cv = np.empty((nx - 1, ny - 1, nz - 1, 8), np.float32)
    for i, (ox, oy, oz) in enumerate(_CORNER):
        cv[..., i] = d[ox: nx - 1 + ox, oy: ny - 1 + oy, oz: nz - 1 + oz]

    inside = cv >= level                                     # [...,8]
    any_in = inside.any(axis=-1)
    all_in = inside.all(axis=-1)
    active = np.argwhere(any_in & ~all_in)                   # [A, 3]
    if active.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    cvals = cv[active[:, 0], active[:, 1], active[:, 2]]     # [A, 8]

    # global grid-vertex ids of the 8 corners of each active cell
    def vid(ix, iy, iz):
        return (ix * ny + iy) * nz + iz

    corner_vid = np.stack(
        [vid(active[:, 0] + ox, active[:, 1] + oy, active[:, 2] + oz)
         for (ox, oy, oz) in _CORNER], axis=-1)              # [A, 8]

    verts_list, faces_list = [], []
    edge_key_list = []
    for tet in _TETS:
        tvals = cvals[:, tet]                                # [A, 4]
        tin = tvals >= level
        code = (tin[:, 0].astype(np.int32) | (tin[:, 1] << 1)
                | (tin[:, 2] << 2) | (tin[:, 3] << 3))
        for c in range(1, 15):
            rows = np.where(code == c)[0]
            if rows.size == 0:
                continue
            for tri in _TRI_TABLE[c]:
                for eid in tri:
                    a, b = _TET_EDGES[eid]
                    ca, cb = tet[a], tet[b]
                    va = cvals[rows, ca]
                    vb = cvals[rows, cb]
                    t = (level - va) / np.where(vb != va, vb - va, 1.0)
                    t = np.clip(t, 0.0, 1.0)
                    ga = corner_vid[rows, ca]
                    gb = corner_vid[rows, cb]
                    lo = np.minimum(ga, gb)
                    hi = np.maximum(ga, gb)
                    # orientation-independent interpolation parameter
                    t_canon = np.where(ga <= gb, t, 1.0 - t)
                    pa_idx = np.stack(
                        [active[rows, 0] + _CORNER[ca, 0],
                         active[rows, 1] + _CORNER[ca, 1],
                         active[rows, 2] + _CORNER[ca, 2]], -1)
                    pb_idx = np.stack(
                        [active[rows, 0] + _CORNER[cb, 0],
                         active[rows, 1] + _CORNER[cb, 1],
                         active[rows, 2] + _CORNER[cb, 2]], -1)
                    lo_idx = np.where((ga <= gb)[:, None], pa_idx, pb_idx)
                    hi_idx = np.where((ga <= gb)[:, None], pb_idx, pa_idx)
                    pos = (lo_idx.astype(np.float64)
                           + t_canon[:, None]
                           * (hi_idx - lo_idx).astype(np.float64))
                    verts_list.append(pos)
                    edge_key_list.append(lo.astype(np.int64) * (nx * ny * nz)
                                         + hi.astype(np.int64))
                n = rows.size
                base = sum(v.shape[0] for v in verts_list[:-3])
                faces_list.append(np.stack(
                    [np.arange(base, base + n),
                     np.arange(base + n, base + 2 * n),
                     np.arange(base + 2 * n, base + 3 * n)], axis=-1))

    verts = np.concatenate(verts_list, axis=0)               # grid coords
    faces = np.concatenate(faces_list, axis=0).astype(np.int64)
    keys = np.concatenate(edge_key_list, axis=0)

    # merge vertices by grid-edge identity -> watertight
    uniq, inv = np.unique(keys, return_inverse=True)
    merged = np.zeros((uniq.shape[0], 3), np.float64)
    merged[inv] = verts                                       # any rep wins
    faces = inv[faces]

    # drop degenerate faces (two corners on the same edge)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    faces = faces[ok]

    world = (np.asarray(origin, np.float64)[None, :]
             + merged * np.asarray(spacing, np.float64)[None, :])
    return world.astype(np.float32), faces.astype(np.int32)


# ------------------------------------------------------------ mesh utils

def face_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a = verts[faces[:, 1]] - verts[faces[:, 0]]
    b = verts[faces[:, 2]] - verts[faces[:, 0]]
    n = np.cross(a, b)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(ln, 1e-12)


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = np.zeros_like(verts)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    ln = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(ln, 1e-12)


def largest_component(verts: np.ndarray, faces: np.ndarray):
    """Keep the largest vertex-connected component (trimesh.split +
    largest, extract_mesh_fast.py:445-466) and drop unreferenced verts.

    Uses the native union-find (native/src/components.cpp) when the
    library is built — the scipy sparse-adjacency fallback costs ~1 min
    at 10^7 faces, the native path a few hundred ms."""
    from .. import native_ext
    if native_ext.available() and faces.shape[0]:
        try:
            return native_ext.largest_component_native(verts, faces)
        except Exception as e:
            print(f"[mesh] native largest_component failed ({e}); "
                  f"falling back to scipy")
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    V = verts.shape[0]
    if faces.shape[0] == 0:
        return verts, faces
    i = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    j = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    adj = coo_matrix((np.ones_like(i), (i, j)), shape=(V, V))
    n_comp, labels = connected_components(adj, directed=False)
    if n_comp > 1:
        counts = np.bincount(labels, minlength=n_comp)
        keep_label = np.argmax(counts)
        vkeep = labels == keep_label
        fkeep = vkeep[faces].all(axis=1)
        faces = faces[fkeep]
    # drop unreferenced vertices
    used = np.zeros(V, bool)
    used[faces.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    return verts[used], remap[faces].astype(np.int32)


def mesh_stats(verts: np.ndarray, faces: np.ndarray) -> dict:
    area = 0.0
    if faces.shape[0]:
        a = verts[faces[:, 1]] - verts[faces[:, 0]]
        b = verts[faces[:, 2]] - verts[faces[:, 0]]
        area = float(0.5 * np.linalg.norm(np.cross(a, b), axis=1).sum())
    return {"vertices": int(verts.shape[0]), "faces": int(faces.shape[0]),
            "area": area,
            "bounds": ([float(x) for x in verts.min(0)] if len(verts)
                       else None,
                       [float(x) for x in verts.max(0)] if len(verts)
                       else None)}


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   rng=None) -> np.ndarray:
    """Area-weighted uniform surface sampling (trimesh.sample semantics,
    used by mesh geometry eval for the 200k-point chamfer sets)."""
    rng = rng or np.random.default_rng(0)
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    # degenerate meshes (NaN vertices, zero-area faces) must not crash
    # the chamfer eval: weight only finite positive-area faces
    areas = np.where(np.isfinite(areas), areas, 0.0)
    total = areas.sum()
    p = (areas / total if total > 0
         else np.full(len(areas), 1.0 / max(len(areas), 1)))
    idx = rng.choice(faces.shape[0], size=n, p=p)
    u = rng.uniform(0, 1, n)
    v = rng.uniform(0, 1, n)
    flip = u + v > 1
    u[flip] = 1 - u[flip]
    v[flip] = 1 - v[flip]
    return (a[idx] + u[:, None] * (b[idx] - a[idx])
            + v[:, None] * (c[idx] - a[idx])).astype(np.float32)
