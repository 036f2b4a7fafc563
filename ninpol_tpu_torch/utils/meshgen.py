"""Structured mesh generators for tests and benchmarks.

The reference ships no mesh files (tests/mesh/ holds only .gitkeep; the
result YAMLs name families hexa/tetra/prism/misc at several refinement
levels).  These generators produce equivalent families on the unit cube:

  * hexa_mesh(n)    n^3 hexahedra (like the reference "hexa" family)
  * tetra_mesh(n)   6*n^3 tetrahedra (each cube split into 6 tets)
  * prism_mesh(n)   2*n^3 wedges (each cube split into 2 prisms)
  * pyramid_tetra_mesh(n)  mixed pyramids+tetra ("misc" family analogue)
  * quad_mesh(n)/triangle_mesh(n)  2D families

All return :class:`ninpol_tpu_torch._io.mesh.Mesh` objects (meshio-compatible).
"""
from __future__ import annotations

import numpy as np

from .._io.mesh import CellBlock, Mesh


def _grid_points(n, dim=3):
    axes = [np.linspace(0.0, 1.0, n + 1)] * dim
    if dim == 3:
        x, y, z = np.meshgrid(*axes, indexing="ij")
        pts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    else:
        x, y = np.meshgrid(*axes, indexing="ij")
        pts = np.stack([x.ravel(), y.ravel(), np.zeros(x.size)], axis=1)
    return pts


def _vertex_ids(n):
    """(n+1,n+1,n+1) lattice of point ids, ij-major like _grid_points."""
    return np.arange((n + 1) ** 3).reshape(n + 1, n + 1, n + 1)


def _cell_corners(n):
    """The 8 corner point ids of each cube cell, meshio hexahedron order:
    [x0y0z0, x1y0z0, x1y1z0, x0y1z0, x0y0z1, x1y0z1, x1y1z1, x0y1z1]."""
    v = _vertex_ids(n)
    i, j, k = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                          indexing="ij")
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    c = [
        v[i, j, k], v[i + 1, j, k], v[i + 1, j + 1, k], v[i, j + 1, k],
        v[i, j, k + 1], v[i + 1, j, k + 1], v[i + 1, j + 1, k + 1],
        v[i, j + 1, k + 1],
    ]
    return np.stack(c, axis=1)


def hexa_mesh(n: int) -> Mesh:
    return Mesh(_grid_points(n), [CellBlock("hexahedron", _cell_corners(n))])


# A standard 6-tet decomposition of the cube (all sharing diagonal 0-6).
_TET_SPLIT = [
    (0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
    (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6),
]


def tetra_mesh(n: int) -> Mesh:
    corners = _cell_corners(n)
    tets = np.concatenate([corners[:, list(t)] for t in _TET_SPLIT], axis=0)
    return Mesh(_grid_points(n), [CellBlock("tetra", tets)])


def prism_mesh(n: int) -> Mesh:
    """Each cube -> 2 wedges split along the x-y diagonal, extruded in z.

    meshio wedge ordering: bottom triangle (0,1,2), top triangle (3,4,5).
    """
    c = _cell_corners(n)
    w1 = c[:, [0, 1, 3, 4, 5, 7]]
    w2 = c[:, [1, 2, 3, 5, 6, 7]]
    wedges = np.concatenate([w1, w2], axis=0)
    return Mesh(_grid_points(n), [CellBlock("wedge", wedges)])


def pyramid_tetra_mesh(n: int) -> Mesh:
    """Mixed mesh: each cube -> 1 bottom pyramid + 4 tets + 1 top pyramid?
    Simpler valid split: cube -> 6 pyramids sharing the cube center.
    """
    pts = _grid_points(n)
    c = _cell_corners(n)
    centers = pts[c].mean(axis=1)
    center_ids = len(pts) + np.arange(len(c))
    all_pts = np.concatenate([pts, centers], axis=0)
    # 6 pyramids per cube, each base = a cube face (outward), apex = center.
    # meshio pyramid: base quad (0,1,2,3) then apex 4.  Base orientation must
    # make a valid (positive-volume) pyramid; use the hexahedron face table.
    faces = [
        (0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
        (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7),
    ]
    pyr = []
    for f in faces:
        base = c[:, list(f)]
        pyr.append(np.concatenate([base, center_ids[:, None]], axis=1))
    pyramids = np.concatenate(pyr, axis=0)
    return Mesh(all_pts, [CellBlock("pyramid", pyramids)])


def mixed_hexa_tetra_mesh(n: int) -> Mesh:
    """CONFORMING mixed hexa/pyramid/tetra mesh (n >= 2).

    x-slabs: [0, h-1) stay hexahedra; slab h-1 is a pyramid transition
    layer (each cube -> 6 center-apex pyramids, except the +x-facing
    pyramid which splits into 2 tets whose face diagonal matches the tet
    region); slabs [h, n) use the 6-tet Kuhn split (all faces' diagonals
    conform across cubes).  Every interior face is shared exactly by two
    cells — no hanging diagonals (the previous hexa|tet construction left
    the interface quads split on one side only)."""
    h = max(n // 2, 1)
    pts = _grid_points(n)
    c = _cell_corners(n)
    i = (np.arange(len(c)) // (n * n)) % n  # x-index (ij-major ordering)

    hexes = c[i < h - 1]
    trans = c[i == h - 1]
    tet_cubes = c[i >= h]

    # transition cubes: center-apex pyramids; +x face -> 2 matching tets
    centers = pts[trans].mean(axis=1)
    center_ids = len(pts) + np.arange(len(trans))
    all_pts = np.concatenate([pts, centers], axis=0)
    faces = [
        (0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
        (2, 3, 7, 6), (3, 0, 4, 7),                 # not the +x face
    ]
    pyr = [np.concatenate([trans[:, list(f)], center_ids[:, None]], axis=1)
           for f in faces]
    pyramids = np.concatenate(pyr, axis=0) if len(trans) else \
        np.zeros((0, 5), np.int64)
    # +x face (1,2,6,5): diagonal 1-6 matches the Kuhn split's 0-7
    # diagonal on the adjacent tet cube's -x face
    t1 = np.concatenate([trans[:, [1, 2, 6]], center_ids[:, None]], axis=1)
    t2 = np.concatenate([trans[:, [1, 6, 5]], center_ids[:, None]], axis=1)

    tets = [t1, t2] if len(trans) else []
    if len(tet_cubes):
        tets.append(np.concatenate(
            [tet_cubes[:, list(t)] for t in _TET_SPLIT], axis=0))
    blocks = []
    if len(hexes):
        blocks.append(CellBlock("hexahedron", hexes))
    if len(pyramids):
        blocks.append(CellBlock("pyramid", pyramids))
    if tets:
        blocks.append(CellBlock("tetra", np.concatenate(tets, axis=0)))
    return Mesh(all_pts, blocks)


def quad_mesh(n: int) -> Mesh:
    pts = _grid_points(n, dim=2)
    v = np.arange((n + 1) ** 2).reshape(n + 1, n + 1)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    i, j = i.ravel(), j.ravel()
    quads = np.stack(
        [v[i, j], v[i + 1, j], v[i + 1, j + 1], v[i, j + 1]], axis=1)
    return Mesh(pts, [CellBlock("quad", quads)])


def triangle_mesh(n: int) -> Mesh:
    pts = _grid_points(n, dim=2)
    v = np.arange((n + 1) ** 2).reshape(n + 1, n + 1)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    i, j = i.ravel(), j.ravel()
    t1 = np.stack([v[i, j], v[i + 1, j], v[i + 1, j + 1]], axis=1)
    t2 = np.stack([v[i, j], v[i + 1, j + 1], v[i, j + 1]], axis=1)
    return Mesh(pts, [CellBlock("triangle", np.concatenate([t1, t2]))])


FAMILIES = {
    "hexa": hexa_mesh,
    "tetra": tetra_mesh,
    "prism": prism_mesh,
    "misc": pyramid_tetra_mesh,
    "mixed": mixed_hexa_tetra_mesh,
    "quad": quad_mesh,
    "triangle": triangle_mesh,
}
