"""The GLS face table: one hand-written CUDA kernel, its wrapper and its
plain PyTorch version.

``face_table(geo, pair, inpofa, perm, diff_mag, neumann)`` builds the
(n_faces, 14) float64 table the stencil gathers of every GLS route read
(``_methods/gls.py::gls_gather``), one row per face:

  [0:3]   the normal N            geo[:, 0:3]
  [3:6]   the centre              geo[:, 3:6]
  [6:9]   K1 N of the first cell  c1 = pair[:, 0]
  [9:12]  K2 N of the second cell c2 = pair[:, 1], c1 where c2 < 0
  [12]    eta = max(diff_mag[c1], diff_mag[c2])
  [13]    the mean of neumann over the face's points (inpofa >= 0), the
          count clamped at 1

with K of cell c the row-major 3 x 3 perm[9 c : 9 c + 9] and (K N)_i =
(K_i0 N_0 + K_i1 N_1) + K_i2 N_2, each product and sum rounded once (the
reference's dgemv, gls.pyx:301-321, read as K @ N); the Neumann values
summed in inpofa's column order.  ninpol_tpu builds the same table with
numpy on the host; no TPU kernel is replaced.

CPU tensors run the plain version, CUDA tensors the kernel in
``csrc/face_table.cu`` (built with nvcc on first use), which gives the
plain version's table bit for bit; ``face_table.launches`` counts kernel
launches, and each launch adds its rows to the recorder's ``face_rows``
counter (utils/tracing.py).  The kernel is bound by memory
(``table_bytes``).
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.tracing import count
from . import cuda_lib
from .cuda_lib import CudaLibrary, check_launch, check_tensor, on_card, stream

_F64 = torch.float64
COLS = 14


def table_bytes(n_faces, n_cells, n_points):
    """The bytes a build reads and writes, each input read once: a face's
    geometry 48, pair 8 and inpofa 16 and its row's 112 written; a cell's K
    72 and diff_mag 8; a point's Neumann value 8.  (Read per face, as each
    thread gathers them, the K rows and values make 376 B a face.)"""
    return 184 * n_faces + 80 * n_cells + 8 * n_points


def face_table_reference(geo, pair, inpofa, perm, diff_mag, neumann):
    """The plain version: the kernel's arithmetic in float64 torch ops."""
    c1 = pair[:, 0].long().clamp_min(0)
    c2 = torch.where(pair[:, 1] >= 0, pair[:, 1].long(), c1)
    K = perm.reshape(-1, 3, 3)
    N = geo[:, 0:3]

    def k_times_n(c):
        Kc = K[c]
        return (Kc[:, :, 0] * N[:, 0:1] + Kc[:, :, 1] * N[:, 1:2]) \
            + Kc[:, :, 2] * N[:, 2:3]

    eta = torch.maximum(diff_mag[c1], diff_mag[c2])
    valid = inpofa >= 0
    vals = torch.where(valid, neumann[inpofa.long().clamp_min(0)], 0.0)
    total = vals[:, 0]
    for j in range(1, vals.shape[1]):
        total = total + vals[:, j]
    mean = total / valid.sum(dim=1).clamp_min(1)
    return torch.cat([geo, k_times_n(c1), k_times_n(c2), eta[:, None],
                      mean[:, None]], dim=1)


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ll, pi, pll = ctypes.c_longlong, ctypes.POINTER(ci), ctypes.POINTER(
        ctypes.c_longlong)
    lib.face_table_occupancy.argtypes = [pll, pi, pi, pi, pll]
    lib.face_table_occupancy.restype = ci
    lib.face_table_launch.argtypes = [vp, vp, vp, ci, vp, vp, vp, vp, ll, vp]
    lib.face_table_launch.restype = ci


library = CudaLibrary("face_table", _bind)


def occupancy():
    """The kernel's launch on the current card (``cuda_lib.occupancy``)."""
    return cuda_lib.occupancy(library.get().face_table_occupancy,
                              "face_table occupancy query")


def face_table(geo, pair, inpofa, perm, diff_mag, neumann):
    """The (n_faces, 14) table of geo (n_faces, 6) float64, pair
    (n_faces, 2) int32, inpofa (n_faces, W) int32 (-1 padded), perm
    (9 n_cells,) float64, diff_mag (n_cells,) float64 and neumann
    (n_points,) float64, all on one device."""
    n, dev = geo.shape[0], geo.device
    width = inpofa.shape[1] if inpofa.dim() == 2 else -1
    check_tensor("geo", geo, (n, 6), _F64, dev)
    check_tensor("pair", pair, (n, 2), torch.int32, dev)
    check_tensor("inpofa", inpofa, (n, width), torch.int32, dev)
    if width < 1:
        raise ValueError(f"inpofa must be (n_faces, W >= 1), got "
                         f"{tuple(inpofa.shape)}")
    n_cells = diff_mag.shape[0]
    check_tensor("perm", perm, (9 * n_cells,), _F64, dev)
    check_tensor("diff_mag", diff_mag, (n_cells,), _F64, dev)
    check_tensor("neumann", neumann, (neumann.shape[0],), _F64, dev)
    if not on_card(geo, "face_table"):
        return face_table_reference(geo, pair, inpofa, perm, diff_mag,
                                    neumann)
    out = torch.empty((n, COLS), dtype=_F64, device=dev)
    with torch.cuda.device(dev):
        err = library.get().face_table_launch(
            geo.data_ptr(), pair.data_ptr(), inpofa.data_ptr(), width,
            perm.data_ptr(), diff_mag.data_ptr(), neumann.data_ptr(),
            out.data_ptr(), n, stream(dev))
    check_launch(err, f"face_table (n_faces={n}, width={width})")
    face_table.launches += 1
    count("face_rows", n)
    return out


face_table.launches = 0
