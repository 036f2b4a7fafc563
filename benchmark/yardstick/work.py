"""The work of a GLS rebuild and the least time an H100 could take for it.

The count is the method's, not the program's: each solved node's own
least-squares system as the upstream builds it (ninpol gls.pyx:75-474),
m = E + 3F rows (+ one Neumann row per boundary face of a Neumann node)
and n = 3E + 1 columns for E cells and F faces, solved by Householder QR
(LAPACK dgels: 2mn^2 - 2n^3/3 FLOPs).  The bytes are the node's geometric
inputs read once (E cell centres, F face rows of 14 float64) and its E + 2
outputs written once.  No padding, layout or algorithm of the program
enters it, so a change to the program cannot move it.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, 700 W: FP64 on the tensor cores, HBM3
PEAK_FP64 = 67e12
PEAK_BYTES = 3.35e12


def solved_nodes(topo, neumann_flag):
    """Points that get a solve: not a Dirichlet boundary point, and with
    a face that is not on the boundary (gls.pyx:165-166, 266-267)."""
    boundary = topo["n_bface"] > 0
    return (~boundary | (neumann_flag > 0)) & (topo["n_bface"]
                                                < topo["n_face"])


def gls_work(topo, neumann_flag):
    """(FLOPs, bytes) of one GLS rebuild of every node."""
    on = solved_nodes(topo, neumann_flag)
    E = topo["n_elem"][on].astype(np.float64)
    F = topo["n_face"][on].astype(np.float64)
    m = E + 3 * F + np.where(neumann_flag[on] > 0, topo["n_bface"][on], 0)
    n = 3 * E + 1
    flops = float(np.sum(2 * m * n * n - 2 * n ** 3 / 3))
    nbytes = float(np.sum(8 * (3 * E + 14 * F + E + 2)))
    return flops, nbytes


def least_ms(flops, nbytes):
    """The least time (ms) and what bounds it: "operations" or "bytes"."""
    t_ops, t_bytes = flops / PEAK_FP64 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
