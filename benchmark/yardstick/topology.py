"""The benchmark's own face topology of a mesh, in torch on any device.

Faces are matched by their three smallest point ids (one key per face of
a conforming mesh).  A face shared by two cells is interior, one seen once
is on the boundary.  The result gives what the problem and the work count
need: every boundary face (its cell, its points in that cell's local
order) and, per point, its cells, faces and boundary faces.  It reads
nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

# each cell type's faces as local point ids, in the upstream schema's
# order and orientation (ninpol utils/point_ordering.yaml: right-hand
# rule, normals out of the cell); -1 pads a triangle among quads
LOCAL_FACES = {
    "tetra": ((0, 2, 1, -1), (0, 1, 3, -1), (1, 2, 3, -1), (0, 3, 2, -1)),
    "hexahedron": ((0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
                   (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7)),
    "wedge": ((0, 2, 1, -1), (3, 4, 5, -1), (0, 1, 4, 3), (1, 2, 5, 4),
              (0, 3, 5, 2)),
    "pyramid": ((0, 3, 2, 1), (0, 1, 4, -1), (1, 2, 4, -1), (2, 3, 4, -1),
                (3, 0, 4, -1)),
}


def half_faces(cells, cell_type):
    """Every (cell, local face) of ``cells`` (an int64 tensor): its points
    (n_cells * n_local, 4, -1 padded) in the cell's local order, its cell
    and its local slot."""
    lf = torch.as_tensor(LOCAL_FACES[cell_type], device=cells.device)
    n_cells, n_local = cells.shape[0], lf.shape[0]
    pts = torch.where(lf >= 0, cells[:, lf.clamp_min(0)], -1)
    cell = torch.arange(n_cells, device=cells.device).repeat_interleave(
        n_local)
    slot = torch.arange(n_local, device=cells.device).repeat(n_cells)
    return pts.reshape(-1, 4), cell, slot


def face_key(pts, n_points):
    """Two int64 keys of each face from its three smallest point ids."""
    s = torch.sort(torch.where(pts >= 0, pts, n_points), dim=1).values
    return s[:, 0] * (n_points + 1) + s[:, 1], s[:, 2]


def lexsort(k1, k2):
    """The order sorting by k1, then k2."""
    o = torch.sort(k2, stable=True).indices
    return o[torch.sort(k1[o], stable=True).indices]


def mesh_faces(cells, cell_type, n_points):
    """Face topology of ``cells`` (int64 tensor on any device).

    Returns a dict of numpy arrays: ``bface_points`` (n_bfaces, 4) in the
    owner's local order, ``bface_cell``; per point ``n_elem``, ``n_face``
    and ``n_bface``; and ``n_faces``.  Raises on a face shared by more
    than two cells."""
    pts, cell, _ = half_faces(cells, cell_type)
    k1, k2 = face_key(pts, n_points)
    order = lexsort(k1, k2)
    k1s, k2s = k1[order], k2[order]
    new = torch.ones(len(order), dtype=torch.bool, device=cells.device)
    new[1:] = (k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1])
    group = torch.cumsum(new, 0) - 1
    size = torch.bincount(group)
    if int(size.max()) > 2:
        raise ValueError("non-manifold mesh: a face has more than 2 cells")
    first = order[new]                       # one half-face per face
    bound = first[size == 1]                 # boundary faces
    # stable sorts keep the lower cell first in each group: the face's
    # defining cell, as the upstream numbers faces by first encounter

    def per_point(hf):
        p = pts[hf].reshape(-1)
        return torch.bincount(p[p >= 0], minlength=n_points)

    return {
        "n_faces": int(len(first)),
        "bface_points": pts[bound].cpu().numpy(),
        "bface_cell": cell[bound].cpu().numpy(),
        "n_elem": torch.bincount(cells.reshape(-1),
                                 minlength=n_points).cpu().numpy(),
        "n_face": per_point(first).cpu().numpy(),
        "n_bface": per_point(bound).cpu().numpy(),
    }


def cell_centres(points, cells):
    """Mean of each cell's points (cells -1 padded), summed in order."""
    k = (cells >= 0).sum(axis=1)
    acc = points[cells[:, 0]].copy()
    for c in range(1, cells.shape[1]):
        on = cells[:, c] >= 0
        acc[on] += points[cells[on, c]]
    return acc * (1.0 / k)[:, None]


def face_centers(points, fpts):
    """Mean of each face's points (float64), summed in the face's order."""
    k = (fpts >= 0).sum(axis=1)
    acc = points[fpts[:, 0]].copy()
    for c in range(1, fpts.shape[1]):
        on = fpts[:, c] >= 0
        acc[on] += points[fpts[on, c]]
    return acc * (1.0 / k)[:, None]


def face_normals(points, fpts):
    """Unit normals of faces from their first three points, with the
    upstream's float32 intermediates (ninpol grid.pyx:721-809: float
    scratch): v1 = p1 - p2, v2 = p3 - p2, n = v1 x v2 / |v1 x v2|."""
    f32 = np.float32
    p1, p2, p3 = (points[fpts[:, i]] for i in range(3))
    v1 = (p1 - p2).astype(f32)
    v2 = (p3 - p2).astype(f32)
    nx = v1[:, 1] * v2[:, 2] - v1[:, 2] * v2[:, 1]
    ny = v1[:, 2] * v2[:, 0] - v1[:, 0] * v2[:, 2]
    nz = v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]
    norm = np.sqrt(nx * nx + ny * ny + nz * nz).astype(f32)
    return np.stack([(nx / norm), (ny / norm), (nz / norm)],
                    axis=1).astype(np.float64)
