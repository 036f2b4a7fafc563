"""Frozen copies of the structured unit-cube meshes the benchmark runs.

Each generator returns ``(points, cells, cell_type)``: float64 points
(n_points, 3), int64 connectivity (n_cells, points per cell) in meshio's
point order, and the meshio cell-type name.  The meshes equal those of the
program's own ``utils/meshgen.py`` (a test holds them to it at small n);
they live here so that no change to the program moves the yardstick.

  * ``hexa``   n^3 hexahedra
  * ``tetra``  6 n^3 tetrahedra, each cube split into 6 around its 0-6
               diagonal
  * ``prism``  2 n^3 wedges, each cube split along its x-y diagonal
"""
from __future__ import annotations

import numpy as np

# the 6-tet split of a cube, all tets sharing the diagonal 0-6
TET_SPLIT = ((0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
             (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6))


def lattice_points(n):
    """(n+1)^3 lattice points of the unit cube, ij-major."""
    axis = np.linspace(0.0, 1.0, n + 1)
    x, y, z = np.meshgrid(axis, axis, axis, indexing="ij")
    return np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)


def cube_corners(n):
    """The 8 corner point ids of each of the n^3 cubes, in meshio's
    hexahedron order [x0y0z0, x1y0z0, x1y1z0, x0y1z0, x0y0z1, x1y0z1,
    x1y1z1, x0y1z1]."""
    v = np.arange((n + 1) ** 3).reshape(n + 1, n + 1, n + 1)
    i, j, k = (a.ravel() for a in np.meshgrid(
        np.arange(n), np.arange(n), np.arange(n), indexing="ij"))
    return np.stack([
        v[i, j, k], v[i + 1, j, k], v[i + 1, j + 1, k], v[i, j + 1, k],
        v[i, j, k + 1], v[i + 1, j, k + 1], v[i + 1, j + 1, k + 1],
        v[i, j + 1, k + 1]], axis=1)


def hexa(n):
    return lattice_points(n), cube_corners(n), "hexahedron"


def tetra(n):
    c = cube_corners(n)
    return (lattice_points(n),
            np.concatenate([c[:, list(t)] for t in TET_SPLIT], axis=0),
            "tetra")


def prism(n):
    c = cube_corners(n)
    return (lattice_points(n),
            np.concatenate([c[:, [0, 1, 3, 4, 5, 7]],
                            c[:, [1, 2, 3, 5, 6, 7]]], axis=0),
            "wedge")


FAMILIES = {"hexa": hexa, "tetra": tetra, "prism": prism}
