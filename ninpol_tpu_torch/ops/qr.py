"""The kernels of the corrected semi-normal equations (CSNE) solve: two
hand-written CUDA kernels, their wrappers and their plain PyTorch
versions.

Replace the Pallas kernels of ninpol_tpu/ops/pallas_qr.py that
ninpol_tpu's ``solver="pallas"`` GLS route runs (its gls.py:659-705):

  qr_r_df32(Ah, Al)    -> qr_r(A)         (B, m, n) -> (B, n, n)
        R of the Householder QR of A: upper triangular, zeros below the
        diagonal, with R_kk = -||x|| where the pivot column's x_k >= 0
        (the TPU kernel's sign convention, so R agrees entry by entry)
  sne_solve_df32(R, b) -> sne_solve(R, b) (B, n, n), (B, n) -> (B, n)
        y with R^T R y = b: forward, then backward substitution; every
        |R_kk| < ``tiny`` counts as exactly 1 in both

The TPU kernels compute in double-float32 pairs because the TPU emulates
float64.  Here both take and return float64, which the H100 has natively.
Each wrapper runs its plain version for CPU tensors and launches its
kernel in ``csrc/qr.cu`` (built with nvcc on first use) for CUDA tensors,
or raises; ``<wrapper>.launches`` counts kernel launches.  ``qr_r`` keeps
a node's whole A in shared memory, so it takes (m | 1) * n + n + 16
doubles up to the H100's 232,448 bytes a block (a wider class raises).
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CudaLibrary, check_launch, check_tensor, on_card, stream
from .solve import householder_sweep

SMEM_LIMIT = 232448      # bytes of shared memory a block may use (H100)
_F64 = torch.float64


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------
def qr_r_reference(A):
    n = A.shape[2]
    return torch.triu(householder_sweep(A.clone(), n)[:, :n, :n])


def _clamp_diagonal(R, tiny):
    """R with every diagonal entry |R_kk| < tiny replaced by 1."""
    d = R.diagonal(dim1=1, dim2=2)
    Rc = R.clone()
    Rc.diagonal(dim1=1, dim2=2).copy_(torch.where(d.abs() < tiny, 1.0, d))
    return Rc


def sne_solve_reference(R, b, tiny=1e-7):
    Rc = _clamp_diagonal(R, tiny)
    z = torch.linalg.solve_triangular(Rc.transpose(1, 2), b[:, :, None],
                                      upper=False)
    return torch.linalg.solve_triangular(Rc, z, upper=True)[:, :, 0]


def r_diag_quality(R):
    """min|diag| / max|diag| of R (B, n, n), the singularity flag of the
    route (pallas_qr.py:223-229)."""
    d = R.diagonal(dim1=1, dim2=2).abs()
    return d.amin(dim=1) / torch.clamp_min(d.amax(dim=1), 1e-30)


# ---------------------------------------------------------------------------
# Errors by which a kernel is held against its plain version: R by backward
# error and y by residual, since y's forward error grows as cond(R)^2
# ---------------------------------------------------------------------------
def gram_backward_error(R, A):
    """max over nodes of max|R^T R - A^T A| / max|A^T A|."""
    G = A.transpose(1, 2) @ A
    d = (R.transpose(1, 2) @ R - G).abs().flatten(1).amax(dim=1)
    return float((d / G.abs().flatten(1).amax(dim=1).clamp_min(1e-30)).max())


def sne_residual(R, y, b, tiny=1e-7):
    """max over nodes of ||Rc^T Rc y - b|| / (||Rc||_F^2 ||y||), Rc = R with
    its clamped pivots set to 1 (the system ``sne_solve`` solves)."""
    Rc = _clamp_diagonal(R, tiny)
    r = torch.einsum("bji,bj->bi", Rc, torch.einsum("bij,bj->bi", Rc, y)) - b
    den = (torch.linalg.matrix_norm(Rc) ** 2
           * torch.linalg.vector_norm(y, dim=1)).clamp_min(1e-300)
    return float((torch.linalg.vector_norm(r, dim=1) / den).max())


# ---------------------------------------------------------------------------
# CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------
def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.qr_r_smem_bytes.argtypes = [ci, ci]
    lib.qr_r_smem_bytes.restype = ctypes.c_longlong
    lib.qr_r_launch.argtypes = [vp, vp, ci, ci, ci, vp]
    lib.sne_solve_launch.argtypes = [vp, vp, vp, ci, ci, ctypes.c_double, vp]
    for f in (lib.qr_r_launch, lib.sne_solve_launch):
        f.restype = ci


library = CudaLibrary("qr", _bind)


def _launch(wrapper, what, fn, *args):
    with torch.cuda.device(args[0].device):
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args], stream())
    check_launch(err, what)
    wrapper.launches += 1


def qr_r(A):
    """(B, m, n) float64, m >= n -> R (B, n, n) of A = QR."""
    if A.dim() != 3:
        raise ValueError(f"A must have 3 dimensions, got {tuple(A.shape)}")
    B, m, n = A.shape
    check_tensor("A", A, (B, m, n), _F64, A.device)
    if m < n:
        raise ValueError(f"A must have at least as many rows as columns, "
                         f"got {m} x {n}")
    if not on_card(A, "qr_r"):
        return qr_r_reference(A)
    lib = library.get()
    need = lib.qr_r_smem_bytes(m, n)
    if need > SMEM_LIMIT:
        raise ValueError(f"qr_r: a {m} x {n} node needs {need} bytes of "
                         f"shared memory, over the {SMEM_LIMIT} a block may "
                         f"use")
    out = torch.empty((B, n, n), dtype=_F64, device=A.device)
    if B:
        _launch(qr_r, f"qr_r (B={B}, m={m}, n={n})", lib.qr_r_launch, A,
                out, B, m, n)
    return out


def sne_solve(R, b, tiny=1e-7):
    """(B, n, n) upper-triangular float64 R, (B, n) b -> y with
    R^T R y = b, every |R_kk| < tiny taken as 1."""
    if R.dim() != 3:
        raise ValueError(f"R must have 3 dimensions, got {tuple(R.shape)}")
    B, n, _ = R.shape
    check_tensor("R", R, (B, n, n), _F64, R.device)
    check_tensor("b", b, (B, n), _F64, R.device)
    if not on_card(R, "sne_solve"):
        return sne_solve_reference(R, b, tiny)
    out = torch.empty((B, n), dtype=_F64, device=R.device)
    if B:
        _launch(sne_solve, f"sne_solve (B={B}, n={n})",
                library.get().sne_solve_launch, R, b, out, B, n, float(tiny))
    return out


for _w in (qr_r, sne_solve):
    _w.launches = 0

# The two pieces of the CSNE solve: the wrappers (kernels on the card),
# and the plain versions
KERNELS = (qr_r, sne_solve)
PLAIN = (qr_r_reference, sne_solve_reference)
