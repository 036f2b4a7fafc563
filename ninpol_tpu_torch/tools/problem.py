"""bench.py's problem, built with the port, and the card's bound.

``build_problem`` is bench.py:33-101 through the port's own meshgen and
Interpolator (no JAX): what ``chip_smoke.py`` and
``tools/kernel_stages.py`` run.  ``bound`` is the least time an H100
could take for a piece of work, the yardstick both print beside a
kernel's time.
"""
from __future__ import annotations

import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, 700 W): FP32 off the tensor cores,
# FP64 on them (DMMA; 34e12 off them), and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_FP64 = 67e12
PEAK_BYTES = 3.35e12


def bound(flops, nbytes, peak=PEAK_FP32, fp64_flops=0.0):
    """The least time (ms) the card could take: the larger of the
    operations over their type's peak (``flops`` at ``peak``, FP32 unless
    stated, and ``fp64_flops`` more at PEAK_FP64) and the bytes over the
    memory rate; with which of the two it is."""
    t_ops = (flops / peak + fp64_flops / PEAK_FP64) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def build_problem(n, shard_geometry=False, family="tetra", mesh=None):
    """bench.py:33-101 with the port's meshgen and Interpolator: a
    ~6n^3-cell tet mesh (``family`` "hexa": n^3 hexahedra), ALH-style
    varying full-tensor K, u = x^2+y^2+z^2, seeded Dirichlet/Neumann
    split, Neumann flux -(K grad u).n at boundary-face centers averaged
    onto the points.  ``mesh`` and ``shard_geometry`` go to the
    Interpolator."""
    from ..interpolator import Interpolator
    from ..utils import meshgen

    mesh_obj = getattr(meshgen, f"{family}_mesh")(n)
    pts = mesh_obj.points
    cells = mesh_obj.cells[0].data
    cents = pts[cells].mean(axis=1)
    x, y, z = cents[:, 0], cents[:, 1], cents[:, 2]
    K = np.zeros((len(cells), 3, 3))
    K[:, 0, 0] = y * y + z * z + 1
    K[:, 0, 1] = K[:, 1, 0] = -x * y
    K[:, 0, 2] = K[:, 2, 0] = -x * z
    K[:, 1, 1] = x * x + z * z + 1
    K[:, 1, 2] = K[:, 2, 1] = -y * z
    K[:, 2, 2] = x * x + y * y + 1
    sol = x ** 2 + y ** 2 + z ** 2

    interp = Interpolator(shard_geometry=shard_geometry, mesh=mesh)
    mesh_obj.cell_data = {"permeability": [K.reshape(-1, 9)], "u": [sol]}
    mesh_obj.point_data = {}
    t0 = time.perf_counter()
    interp.load_mesh(mesh_obj=mesh_obj)
    build_s = time.perf_counter() - t0
    grid = interp.grid

    rng = np.random.default_rng(0)
    boundary = np.nonzero(grid.boundary_faces)[0]
    ridx = rng.choice(len(boundary), len(boundary) // 2, replace=False)
    neumann_faces = np.setdiff1d(boundary, boundary[ridx])
    pv = np.zeros(grid.n_points)
    dpts = grid.inpofa[boundary[ridx]].ravel()
    np.add.at(pv, dpts[dpts != -1], 1)
    npts = grid.inpofa[neumann_faces].ravel()
    np.add.at(pv, npts[npts != -1], -1)
    bpts = np.nonzero(grid.boundary_points)[0]
    neumann_points = bpts[pv[bpts] < 0]

    owners = grid.esuf[grid.esuf_ptr[boundary]]
    fc = grid.faces_centers[boundary]
    flux = -np.einsum("fij,fj->fi", K[owners], 2 * fc)
    nval_faces = np.zeros(grid.n_faces)
    nval_faces[boundary] = np.einsum(
        "fi,fi->f", flux, grid.normal_faces[boundary])
    counts = np.diff(grid.fsup_ptr)
    owner_pt = np.repeat(np.arange(grid.n_points), counts)
    sums = np.bincount(owner_pt, weights=nval_faces[grid.fsup],
                       minlength=grid.n_points)
    neumann = np.zeros(grid.n_points)
    neumann[neumann_points] = (sums / np.maximum(counts, 1))[neumann_points]
    nflag = np.zeros(grid.n_points)
    nflag[neumann_points] = 1
    interp.load_data({"neumann_u": neumann, "neumann_flag_u": nflag,
                      "dirichlet_flag_u": 1 - nflag}, "points")
    return interp, build_s
