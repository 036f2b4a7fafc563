"""The kernels of the corrected semi-normal equations (CSNE) solve: two
hand-written CUDA kernels, their wrappers and their plain PyTorch
versions.

Replace the Pallas kernels of ninpol_tpu/ops/pallas_qr.py that
ninpol_tpu's ``solver="pallas"`` GLS route runs (its gls.py:659-705):

  qr_r_df32(Ah, Al)    -> qr_r(A)         (B, m, n) -> (B, n, n)
        R of the Householder QR of Ar = [A; diag(dead)], A with an
        identity row appended for each dead (all-zero) column, as the
        route factors it (ninpol_tpu gls.py:674-686): upper triangular,
        zeros below the diagonal, with R_kk = -||x|| where the pivot
        column's x_k >= 0 (the TPU kernel's sign convention, so R agrees
        entry by entry).  A dead column j gives R's row j = -e_j.  Needs
        m >= n, which every class of the route has: m - n = 3F - 2E - 1
        (+F with Neumann rows), and a node has at least as many faces as
        cells (each cell has two or more faces at the node, each face two
        cells at most), so F >= E in every class.
  sne_solve_df32(R, b) -> sne_solve(R, b) (B, n, n), (B, n) -> (B, n)
        y with R^T R y = b: forward, then backward substitution; every
        |R_kk| < ``tiny`` counts as exactly 1 in both

The TPU kernels compute in double-float32 pairs because the TPU emulates
float64.  Here both take and return float64, which the H100 has natively.
Each wrapper runs its plain version for CPU tensors and launches its
kernel in ``csrc/qr.cu`` (built with nvcc on first use) for CUDA tensors,
or raises; ``<wrapper>.launches`` counts kernel launches.  ``qr_r`` never
builds Ar: the kernel writes a dead column's closed form.  It keeps a
node's A in registers where a register tile holds the class (path 2),
else in shared memory, or, past the 227 KB a block may use, in a per-node
workspace it allocates (path 1).  ``sne_solve`` runs a warp a node on the
node's triangle staged in shared memory (path 2); past shared memory
(n > 240) one block a node reads R from device memory (path 1).
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .cuda_lib import CudaLibrary, check_launch, check_tensor, on_card, stream
from .solve import householder_sweep

_F64 = torch.float64


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------
def dead_columns(A):
    """(B, n) bool: the all-zero columns of A (B, m, n)."""
    return torch.sum(A * A, dim=1) == 0


def with_dead_rows(A):
    """Ar = [A; diag(dead)] (B, m + n, n): what ``qr_r`` factors."""
    return torch.cat([A, torch.diag_embed(dead_columns(A).to(A.dtype))],
                     dim=1)


def qr_r_reference(A):
    n = A.shape[2]
    # without a dead column Ar's rows past m are zero and change no R
    Ar = with_dead_rows(A) if dead_columns(A).any() else A.clone()
    return torch.triu(householder_sweep(Ar, n)[:, :n, :n])


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
    ll, pi, pll = ctypes.c_longlong, ctypes.POINTER(ci), ctypes.POINTER(
        ctypes.c_longlong)
    lib.qr_r_path.argtypes = [ci, ci]
    lib.qr_r_path.restype = ci
    lib.qr_r_workspace_doubles.argtypes = [ci, ci]
    lib.qr_r_workspace_doubles.restype = ll
    lib.qr_r_occupancy.argtypes = [ci, ci, ci, pll, pi, pi, pi, pll]
    lib.qr_r_occupancy.restype = ci
    lib.qr_r_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
    lib.sne_solve_path.argtypes = [ci]
    lib.sne_solve_path.restype = ci
    lib.sne_solve_occupancy.argtypes = [ci, ci, pll, pi, pi, pi, pll]
    lib.sne_solve_occupancy.restype = ci
    lib.sne_solve_launch.argtypes = [vp, vp, vp, ci, ci, ctypes.c_double, vp]
    lib.sne_solve_path_launch.argtypes = [vp, vp, vp, ci, ci, ctypes.c_double,
                                          ci, vp]
    for f in (lib.qr_r_launch, lib.sne_solve_launch,
              lib.sne_solve_path_launch):
        f.restype = ci


library = CudaLibrary("qr", _bind)


def _launch(wrapper, what, fn, *args):
    """Launch on the stream of the first argument's device; the caller
    holds that device current (``torch.cuda.device``) around this call and
    around every library query that sizes the launch, since the library
    reads the current device."""
    err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in args], stream(args[0].device))
    check_launch(err, what)
    wrapper.launches += 1


def qr_r(A, path=0):
    """(B, m, n) float64, m >= n -> R (B, n, n) of [A; diag(dead)].
    ``path`` picks the kernel's body: 0 the default, 1 shared memory (or
    the workspace), 2 the register tile (raises where none holds m x n)."""
    if A.dim() != 3:
        raise ValueError(f"A must have 3 dimensions, got {tuple(A.shape)}")
    B, m, n = A.shape
    check_tensor("A", A, (B, m, n), _F64, A.device)
    if m < n:
        raise ValueError(f"A must have at least as many rows as columns, "
                         f"got {m} x {n}")
    if not on_card(A, "qr_r"):
        return qr_r_reference(A)
    out = torch.empty((B, n, n), dtype=_F64, device=A.device)
    if B:
        with torch.cuda.device(A.device):
            lib = library.get()
            path = path or lib.qr_r_path(m, n)
            ws = lib.qr_r_workspace_doubles(m, n) if path == 1 else 0
            ws = torch.empty(B * ws, dtype=_F64, device=A.device) if ws \
                else None
            _launch(qr_r, f"qr_r (B={B}, m={m}, n={n}, path={path})",
                    lib.qr_r_launch, A, out, ws, B, m, n, path)
    return out


def occupancy(m, n, path=0):
    """The launch of ``qr_r``'s body ``path`` (0: the default) on an
    m x n node on the current card (``cuda_lib.occupancy``)."""
    return cuda_lib.occupancy(library.get().qr_r_occupancy,
                              f"qr_r occupancy query (m={m}, n={n}, "
                              f"path={path})", m, n, path)


def sne_solve_occupancy(n, path=0):
    """The launch of ``sne_solve``'s body ``path`` (0: the default) at
    width n on the current card (``cuda_lib.occupancy``)."""
    return cuda_lib.occupancy(library.get().sne_solve_occupancy,
                              f"sne_solve occupancy query (n={n}, "
                              f"path={path})", n, path)


def sne_solve(R, b, tiny=1e-7, path=0):
    """(B, n, n) upper-triangular float64 R, (B, n) b -> y with
    R^T R y = b, every |R_kk| < tiny taken as 1; R's lower triangle is
    not read.  ``path`` picks the kernel's body: 0 the default, 1 R read
    from device memory, 2 a warp a node on its staged triangle (raises
    where the triangle passes shared memory)."""
    if R.dim() != 3:
        raise ValueError(f"R must have 3 dimensions, got {tuple(R.shape)}")
    B, n, _ = R.shape
    check_tensor("R", R, (B, n, n), _F64, R.device)
    check_tensor("b", b, (B, n), _F64, R.device)
    if not on_card(R, "sne_solve"):
        return sne_solve_reference(R, b, tiny)
    out = torch.empty((B, n), dtype=_F64, device=R.device)
    if B:
        with torch.cuda.device(R.device):
            _launch(sne_solve, f"sne_solve (B={B}, n={n}, path={path})",
                    library.get().sne_solve_path_launch, R, b, out, B, n,
                    float(tiny), path)
    return out


for _w in (qr_r, sne_solve):
    _w.launches = 0

# The two pieces of the CSNE solve: the wrappers (kernels on the card),
# and the plain versions
KERNELS = (qr_r, sne_solve)
PLAIN = (qr_r_reference, sne_solve_reference)
