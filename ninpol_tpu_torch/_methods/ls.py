"""Least-squares (linear-fit) node interpolation on PyTorch.

Counterpart of ninpol_tpu/_methods/ls.py, a behavioral rebuild of
ninpol/_methods/ls.pyx:33-136: an unweighted linear least-squares fit
over the surrounding cell centroids, solved with the hand-rolled 3x3
cofactor formulas of the reference:

  * moments Ix..Izz of the centroid offsets (ls.pyx:64-77),
  * 2D degeneracy guard: Izz = 1 when all z-moments vanish (ls.pyx:79-80),
  * lambda_x/y/z via the cofactor expressions (ls.pyx:108-124), in the
    same order of operations,
  * weight_i = (1 + lambda . dv_i) / (n + lambda . I) (ls.pyx:126-136),
  * a degenerate system falls back to plain inverse-distance weights
    (ls.pyx:88-102; unlike IDW there is no exact-hit handling and the
    distances use all 3 coordinates).  Degenerate is ninpol_tpu's
    relative test |D| <= 1e-12 * Dabs, not the reference's D == 0,
  * Dirichlet boundary nodes skipped (ls.pyx:58-59).

Exact for linear fields; never writes the Neumann vector.  ninpol_tpu has
no Pallas kernel here: float64 torch ops, run by idw.simple_prepare.
"""
from __future__ import annotations

import torch

from .idw import simple_prepare


def ls_math(xv, cen, cell_valid, n_elem):
    """LS weights (B, E) of ``idw.simple_gather``'s stencil (counterpart
    of ninpol_tpu ls.py::_ls_math), the denominator n + lambda . I and
    the degenerate-node mask."""
    dv = torch.where(cell_valid[:, :, None], cen - xv[:, None, :], 0.0)
    dx, dy, dz = dv[:, :, 0], dv[:, :, 1], dv[:, :, 2]

    Ix = torch.sum(dx, dim=1)
    Iy = torch.sum(dy, dim=1)
    Iz = torch.sum(dz, dim=1)
    Ixx = torch.sum(dx * dx, dim=1)
    Ixy = torch.sum(dx * dy, dim=1)
    Ixz = torch.sum(dx * dz, dim=1)
    Iyy = torch.sum(dy * dy, dim=1)
    Iyz = torch.sum(dy * dz, dim=1)
    Izz = torch.sum(dz * dz, dim=1)

    guard = (Iz == 0.0) & (Izz == 0.0) & (Ixz == 0.0) & (Iyz == 0.0)
    Izz = torch.where(guard, 1.0, Izz)                      # ls.pyx:79-80

    D = (Ixx * (Iyy * Izz - Iyz * Iyz)
         + Ixy * (Iyz * Ixz - Ixy * Izz)
         + Ixz * (Ixy * Iyz - Iyy * Ixz))
    # ninpol_tpu's degeneracy test, relative to the terms' magnitudes
    Dabs = (torch.abs(Ixx) * (torch.abs(Iyy * Izz) + Iyz * Iyz)
            + torch.abs(Ixy) * (torch.abs(Iyz * Ixz) + torch.abs(Ixy * Izz))
            + torch.abs(Ixz) * (torch.abs(Ixy * Iyz) + torch.abs(Iyy * Ixz)))
    is_degen = torch.abs(D) <= 1e-12 * Dabs
    Dsafe = torch.where(is_degen, 1.0, D)
    lx = (Ix * (Iyz * Iyz - Iyy * Izz)
          + Iy * (Ixy * Izz - Iyz * Ixz)
          + Iz * (Iyy * Ixz - Ixy * Iyz)) / Dsafe
    ly = (Ix * (Ixy * Izz - Iyz * Ixz)
          + Iy * (Ixz * Ixz - Ixx * Izz)
          + Iz * (Ixx * Iyz - Ixy * Ixz)) / Dsafe
    lz = (Ix * (Iyy * Ixz - Ixy * Iyz)
          + Iy * (Ixx * Iyz - Ixy * Ixz)
          + Iz * (Ixy * Ixy - Ixx * Iyy)) / Dsafe

    denom = n_elem.to(dv.dtype) + lx * Ix + ly * Iy + lz * Iz
    w_ls = (1.0 + lx[:, None] * dx + ly[:, None] * dy
            + lz[:, None] * dz) / denom[:, None]

    # the degenerate fallback: plain 1/dist normalization (ls.pyx:88-102)
    dist = torch.sqrt(torch.sum(dv * dv, dim=2))
    inv = torch.where(cell_valid,
                      1.0 / torch.where(cell_valid, dist, 1.0), 0.0)
    w_idw = inv / torch.sum(inv, dim=1, keepdim=True)

    w = torch.where(cell_valid, torch.where(is_degen[:, None], w_idw, w_ls),
                    0.0)
    return w, denom, is_degen


class LSInterpolation:
    """The reference prepare() contract (ls.pyx:21-31)."""

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
            return ls_math(*stencil)[0]

        return simple_prepare(math, self.chunk_nodes, dgrid, points_data,
                              variable_to_index, variable, target_points,
                              weights, neumann_ws, device_out,
                              self.delivery_f32)
