"""Inverse-distance-weighting node interpolation on PyTorch.

Counterpart of ninpol_tpu/_methods/idw.py, a behavioral rebuild of
ninpol/_methods/idw.pyx:35-84:
  * weight_j = (1/dist(node, centroid_j)) / sum_k 1/dist, over the node's
    surrounding cells in esup order,
  * exact hit: the FIRST cell with squared distance <= float32(1e-15)
    gets weight 1 and all others 0 (idw.pyx:69-74),
  * Dirichlet boundary nodes (boundary and not Neumann) are skipped
    (idw.pyx:62-63) and the Neumann vector is never written,
  * distances use only the first ``dim`` coordinates (idw.pyx:66-67).

ninpol_tpu has no Pallas kernel here: the weights are float64 torch ops
on the DeviceGrid tensors, one batch per chunk of a stencil class.  The
chunk loop (``simple_prepare``) is shared with LS (ls.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..parallel.sharding import schedule, to_device
from ..utils.tracing import to_host, upload

EXACT_EPS = float(np.float32(1e-15))  # idw.pyx:53 (C float of 1e-15)


def simple_gather(dgrid, nodes, E):
    """The stencil of a chunk of nodes: their coordinates (B, 3), the
    centroids of their first E surrounding cells (B, E, 3), the
    cell-valid mask (B, E) and the cell count min(esup_cnt, E)."""
    dev = nodes.device
    KSetv = dgrid.esup2d[nodes, :E]
    n_elem = torch.clamp_max(dgrid.esup_cnt[nodes], E)
    cell_valid = ((torch.arange(E, device=dev)[None, :] < n_elem[:, None])
                  & (KSetv >= 0))
    KS = torch.where(cell_valid, KSetv, 0).long()
    return (dgrid.point_coords[nodes], dgrid.centroids[KS], cell_valid,
            n_elem)


def idw_math(xv, xc, cell_valid, n_elem, *, dim):
    """IDW weights (B, E) of ``simple_gather``'s stencil (counterpart of
    ninpol_tpu idw.py::_idw_math)."""
    E = xc.shape[1]
    d2 = torch.sum((xv[:, None, :dim] - xc[:, :, :dim]) ** 2, dim=2)
    hit = cell_valid & (d2 <= EXACT_EPS)
    any_hit = hit.any(dim=1)
    cols = torch.arange(E, device=xv.device)
    first_hit = torch.where(hit, cols[None, :], E).amin(dim=1)

    d = torch.sqrt(torch.where(cell_valid, d2, 1.0))
    inv = torch.where(cell_valid, 1.0 / d, 0.0)
    w = inv / torch.sum(inv, dim=1, keepdim=True)

    onehot = (cols[None, :] == first_hit[:, None]).to(w.dtype)
    w = torch.where(any_hit[:, None], onehot, w)
    return torch.where(cell_valid, w, 0.0)


def simple_prepare(math, chunk_nodes, dgrid, points_data, variable_to_index,
                   variable, target_points, weights, neumann_ws, device_out,
                   delivery_f32=False):
    """The IDW/LS prepare(): ``math(*simple_gather(...))`` on every chunk of
    every stencil class of the active target nodes (not Dirichlet), each
    class's nodes split over the grid's shards (``parallel.schedule``) and
    gathered on their shard's device; the rows are copied to the primary
    device and scattered into (n_target, ncols + 1) float64 there, whose
    Neumann column stays zero.  Returns that tensor with ``device_out``,
    else fills and returns the host (weights, neumann_ws), the rows cast
    to float32 on the device first with ``delivery_f32`` (ninpol_tpu
    device_grid.py:573-611)."""
    grid = dgrid.grid
    nf_idx = variable_to_index["points"]["neumann_flag_" + variable]
    neumann_flag = points_data[nf_idx]
    tp = np.asarray(target_points)
    active = ~(grid.boundary_points[tp].astype(bool)
               & (neumann_flag[tp] == 0))
    dev = dgrid.device
    ncols = weights.shape[1]
    wdev = torch.zeros((len(tp), ncols + 1), dtype=torch.float64,
                       device=dev)
    # classes by the cell count alone: these methods read no faces
    for c in dgrid.buckets(tp, active):
        E = c["E"]
        k = min(E, ncols)
        for s, lo, hi in schedule(len(c["nodes"]), len(dgrid.shards),
                                  chunk_nodes):
            view = dgrid.on(s)
            nodes = upload(c["nodes"][lo:hi], view.device)
            pos = upload(c["pos"][lo:hi], dev)
            w = math(*simple_gather(view, nodes, E))
            if view.device != dev:
                w, = to_device(dev, w)
            wdev[pos, :k] = w[:, :k]
    if device_out:
        return wdev
    rows = wdev[:, :ncols]
    weights[:] = to_host(rows.float() if delivery_f32 else rows).numpy()
    return weights, neumann_ws


class IDWInterpolation:
    """The reference prepare() contract (idw.pyx:14-30)."""

    def __init__(self, logging=False):
        self.logging = logging
        # nodes per batch (ninpol_tpu's chunk_nodes)
        self.chunk_nodes = 131072
        # host delivery in float32 (set by the Interpolator)
        self.delivery_f32 = False

    def prepare(self, dgrid, cells_data, points_data, faces_data,
                variable_to_index, variable, target_points,
                weights, neumann_ws, device_out=False):
        def math(*stencil):
            return idw_math(*stencil, dim=dgrid.dim)

        return simple_prepare(math, self.chunk_nodes, dgrid, points_data,
                              variable_to_index, variable, target_points,
                              weights, neumann_ws, device_out,
                              self.delivery_f32)
