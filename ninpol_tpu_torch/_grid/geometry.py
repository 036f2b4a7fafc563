"""Mesh geometry: centroids, face centers, normals, areas, diffusion magnitude.

Vectorized NumPy host implementations matching the reference formulas:

  * centroids: plain vertex average, per-coordinate ``+= coord / npoel``
    (reference: grid.pyx:699-704); only the first ``dim`` coordinates are
    written (z stays 0 for 2D meshes).
  * face centers: vertex average over the face's points (grid.pyx:706-717).
  * face normals/areas: the reference computes these with C ``float``
    (binary32) intermediates (grid.pyx:732-736 declare ``float`` scratch)
    even though the output arrays are float64.  That float32 rounding is
    visible at ~1e-7 relative in the stored normals, and therefore in every
    GLS weight.  To stay within 1e-10 of the reference the same float32
    arithmetic chain is reproduced here (``precise=False``, default).  Pass
    ``precise=True`` for full float64 geometry (better accuracy, not
    reference-parity).
  * diff_mag = (1 - 3*det(K)^(1/3)/trace(K))^2 (interpolator.pyx:501-509).
"""
from __future__ import annotations

import numpy as np

from ..defines import DTYPE_F
from .. import native


def _face_geometry_native(point_coords, inpofa, dim, precise=False):
    """One native pass over faces -> (centers, normals, areas), or None.

    Bit-identical to the NumPy wrappers below (same accumulation order,
    same float32 intermediate chain)."""
    if not native.available() or inpofa.shape[0] == 0:
        return None
    n_faces = inpofa.shape[0]
    coords = np.ascontiguousarray(point_coords, dtype=np.float64)
    inpofa = np.ascontiguousarray(inpofa, dtype=np.int32)
    centers = np.zeros((n_faces, 3), dtype=DTYPE_F)
    normals = np.zeros((n_faces, 3), dtype=DTYPE_F)
    areas = np.zeros(n_faces, dtype=DTYPE_F)
    native.lib().compute_face_geometry(
        n_faces, inpofa, coords, dim, int(precise),
        centers, normals, areas)
    return centers, normals, areas


def calculate_centroids(point_coords, connectivity, element_types, npoel,
                        dim):
    """Element centroids = average of the element's points
    (reference: grid.pyx:669-704).

    Processed per element type so the hot path is unmasked slicing/gather
    (the reference accumulates coord/npoel term by term; the float64
    summation-order difference is ~1e-16, far below the 1e-10 budget).
    """
    n_elems = connectivity.shape[0]
    centroids = np.zeros((n_elems, 3), dtype=DTYPE_F)
    if native.available() and n_elems:
        native.lib().compute_centroids(
            n_elems, connectivity.shape[1],
            np.ascontiguousarray(connectivity, dtype=np.int32),
            np.ascontiguousarray(element_types, dtype=np.int32),
            np.ascontiguousarray(npoel, dtype=np.int32),
            np.ascontiguousarray(point_coords, dtype=np.float64),
            dim, centroids)
        return centroids
    types = np.unique(element_types)
    for t in types:
        k = int(npoel[t])
        sel = (slice(None) if len(types) == 1
               else np.nonzero(element_types == t)[0])
        conn_t = connectivity if len(types) == 1 else connectivity[sel]
        # column-wise gathers + in-place accumulation: one (n, 3) pass per
        # vertex slot instead of a (n, k, 3) temporary + strided reduce
        acc = point_coords[conn_t[:, 0]].copy()
        for c in range(1, k):
            acc += point_coords[conn_t[:, c]]
        acc *= 1.0 / k
        centroids[sel, :dim] = acc[:, :dim]
    return centroids


def calculate_face_centers(point_coords, inpofa, dim):
    """Face centers = average of the face's points (grid.pyx:706-717)."""
    n_faces = inpofa.shape[0]
    centers = np.zeros((n_faces, 3), dtype=DTYPE_F)
    counts = (inpofa >= 0).sum(axis=1)
    kinds = np.unique(counts)
    for k in kinds:
        sel = (slice(None) if len(kinds) == 1
               else np.nonzero(counts == k)[0])
        conn = inpofa if len(kinds) == 1 else inpofa[sel]
        acc = point_coords[conn[:, 0]].copy()
        for c in range(1, k):
            acc += point_coords[conn[:, c]]
        acc *= 1.0 / k
        centers[sel, :dim] = acc[:, :dim]
    return centers


def calculate_normals(point_coords, inpofa, dim, precise=False):
    """Face unit normals and areas (reference: grid.pyx:721-809).

    3D: cross product of the first three points (two-triangle rule for quad
    areas); 2D: 90-degree rotation of the edge vector.  When ``precise`` is
    False the float32 intermediate rounding of the reference is reproduced.
    """
    ftype = np.float64 if precise else np.float32
    n_faces = inpofa.shape[0]
    normals = np.zeros((n_faces, 3), dtype=DTYPE_F)
    areas = np.zeros(n_faces, dtype=DTYPE_F)
    if n_faces == 0:
        return normals, areas

    if dim == 3:
        p1 = point_coords[inpofa[:, 0]]
        p2 = point_coords[inpofa[:, 1]]
        p3 = point_coords[inpofa[:, 2]]
        v1 = (p1 - p2).astype(ftype)    # C: double difference stored to float
        v2 = (p3 - p2).astype(ftype)
        nx = v1[:, 1] * v2[:, 2] - v1[:, 2] * v2[:, 1]
        ny = v1[:, 2] * v2[:, 0] - v1[:, 0] * v2[:, 2]
        nz = v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]
        sumsq = nx * nx + ny * ny + nz * nz
        norm = np.sqrt(sumsq).astype(ftype)              # f32(sqrt) chain
        normals[:, 0] = (nx / norm).astype(DTYPE_F)
        normals[:, 1] = (ny / norm).astype(DTYPE_F)
        normals[:, 2] = (nz / norm).astype(DTYPE_F)

        is_quad = inpofa[:, 3] != -1
        areas[:] = norm.astype(DTYPE_F) / 2.0            # triangle default
        if is_quad.any():
            q = np.nonzero(is_quad)[0]
            p4 = point_coords[inpofa[q, 3]]
            w1 = (p1[q] - p4).astype(ftype)
            w2 = (p3[q] - p4).astype(ftype)
            mx = w1[:, 1] * w2[:, 2] - w1[:, 2] * w2[:, 1]
            my = w1[:, 2] * w2[:, 0] - w1[:, 0] * w2[:, 2]
            mz = w1[:, 0] * w2[:, 1] - w1[:, 1] * w2[:, 0]
            sumsq2 = (mx * mx + my * my + mz * mz).astype(DTYPE_F)
            # reference: (float norm + double sqrt(float sumsq2)) / 2.0
            areas[q] = (norm[q].astype(DTYPE_F) + np.sqrt(sumsq2)) / 2.0
    else:
        p1 = point_coords[inpofa[:, 0]]
        p2 = point_coords[inpofa[:, 1]]
        v1 = (p1 - p2).astype(ftype)
        nx = -v1[:, 1]
        ny = v1[:, 0]
        norm = np.sqrt(nx * nx + ny * ny).astype(ftype)
        normals[:, 0] = (nx / norm).astype(DTYPE_F)
        normals[:, 1] = (ny / norm).astype(DTYPE_F)
        areas[:] = norm.astype(DTYPE_F)
    return normals, areas


def compute_diffusion_magnitude(permeability):
    """diff_mag = (1 - 3 det(K)^(1/3) / tr(K))^2
    (reference: interpolator.pyx:501-509)."""
    Ks = np.reshape(np.asarray(permeability, dtype=DTYPE_F), (-1, 3, 3))
    detKs = np.linalg.det(Ks)
    trKs = np.trace(Ks, axis1=1, axis2=2)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.asarray((1 - (3 * (detKs ** (1 / 3)) / trKs)) ** 2,
                          dtype=DTYPE_F)
