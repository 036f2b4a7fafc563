"""Face-data -> node-data conversion.

Counterpart of ninpol_tpu/utils/face_data_to_node.py (the reference ships
only a placeholder for it, ninpol/utils/face_data_to_node.py:1-3): given
per-face values, produce per-node values using either the plain mean over
each node's surrounding faces (fsup) or inverse-distance weighting by
face-center distance.  Vectorized NumPy, a one-time host conversion like
mesh ingestion.
"""
from __future__ import annotations

import numpy as np


def face_data_to_node(grid, face_values, method="mean"):
    """Convert per-face data (n_faces,) or (n_faces, k) to per-node data.

    method:
      "mean" — arithmetic mean over the node's faces (matches the
               averaging the reference applies to Neumann face fluxes,
               tests/utils/analytical.py:212).
      "idw"  — weights 1/dist(node, face_center).
    """
    face_values = np.asarray(face_values, dtype=np.float64)
    squeeze = face_values.ndim == 1
    vals = face_values.reshape(grid.n_faces, -1)

    counts = np.diff(grid.fsup_ptr)
    owner = np.repeat(np.arange(grid.n_points), counts)
    faces = grid.fsup

    if method == "mean":
        w = np.ones(len(faces))
    elif method == "idw":
        d = np.linalg.norm(
            grid.point_coords[owner] - grid.faces_centers[faces], axis=1)
        w = 1.0 / np.maximum(d, 1e-300)
    else:
        raise ValueError(f"Unknown method '{method}'")

    wsum = np.bincount(owner, weights=w, minlength=grid.n_points)
    out = np.empty((grid.n_points, vals.shape[1]))
    for k in range(vals.shape[1]):
        acc = np.bincount(owner, weights=w * vals[faces, k],
                          minlength=grid.n_points)
        out[:, k] = acc / np.maximum(wsum, 1e-300)
    out[counts == 0] = 0.0
    return out[:, 0] if squeeze else out
