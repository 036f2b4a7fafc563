"""The pieces of the unfused shifted-CholeskyQR2 preconditioner: four
hand-written CUDA kernels, their wrappers and their plain PyTorch
versions.

Replace the Pallas kernels of ninpol_tpu/ops/pallas_chol.py that
ninpol_tpu's unfused GLS route composes (its gls.py:602-658):

  gram_f32(A)                       (B,m,n) -> (B,n,n)    A^T A
  chol_linv_f32(G, tiny, mul_right) (B,n,n) [, (B,n,n)] -> (B,n,n)
        L^-1 (or L^-1 P) of G = L L^T, every pivot clamped at ``tiny``:
        dinv_k = rsqrt(max(pivot_k, tiny)); a clamped pivot shows up as
        |diag| ~ 1/sqrt(tiny), which callers test against SICK_DINV
  round2_gram_f32(A, Li)            (B,m,n), (B,n,n) -> (B,n,n)
        (A Li^T)^T (A Li^T), without Q = A Li^T leaving the kernel
  prec_apply_f32(Lc, v)             (B,n,n), (B,n) -> (B,n)   Lc^T (Lc v)
        Lc lower triangular (the route's L2^-1 L1^-1)

All float32 (FP32 FMAs, never TF32: the preconditioner relies on Gram
products accurate to ~eps32), natural (node, row, column) layout, any B.
Each wrapper runs its plain version for CPU tensors and launches its
kernel in ``csrc/cholqr.cu`` (built with nvcc on first use) for CUDA
tensors, or raises; ``<wrapper>.launches`` counts kernel launches.  The
kernels stage a node's matrices in shared memory; gram_f32,
round2_gram_f32 and chol_linv_f32 keep their sums in registers up to
n = 76, 76 and 80, and prec_apply_f32 runs a warp a node up to n = 128.
gram_f32, round2_gram_f32 and prec_apply_f32 take ``path=`` to pick a
body (0 the default, which ``<name>_path(n)`` in the library gives; 1
shared memory; 2 the register or warp body), and ``occupancy(name, n,
path)`` gives a body's launch on an SM.  Past n ~152 (round2_gram_f32),
~170 (chol_linv_f32), ~226 (gram_f32) or ~240 (prec_apply_f32) the
shared-memory body runs on a per-node workspace in device memory, which
the wrapper allocates (``<name>_workspace_floats(n)`` in the library
gives its size, 0 where the node fits).  chol_linv_f32 reads
``mul_right``, round2_gram_f32 ``Li`` and prec_apply_f32 ``Lc`` as lower
triangular, as the route's (L1^-1, L2^-1 L1^-1) are: no body of
prec_apply_f32 reads Lc's upper triangle, while the plain version reads
all of it, so the two agree wherever Lc is lower triangular.

``cholqr_factors`` composes the four into the preconditioner, from the
wrappers (``KERNELS``) or from the plain versions (``PLAIN``).
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .cuda_lib import CudaLibrary, check_launch, check_tensor, on_card, stream

SICK_DINV = 3e4          # clamped-pivot flag threshold on |diag(L^-1)|
_F32 = torch.float32


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------
def _chol_clamped(G, tiny):
    """Column-by-column Cholesky with pivots clamped at ``tiny``.

    Returns the factor with its diagonal replaced by 1/dinv, dinv =
    rsqrt(max(pivot, tiny)) = diag(L^-1).  A clamped pivot shows up as
    dinv ~ 1/sqrt(tiny); torch.linalg.cholesky would raise instead."""
    B, n, _ = G.shape
    L = torch.zeros_like(G)
    dinv = torch.empty((B, n), dtype=G.dtype, device=G.device)
    for k in range(n):
        col = G[:, k:, k] - torch.einsum("bip,bp->bi", L[:, k:, :k],
                                         L[:, k, :k])
        d = torch.rsqrt(torch.clamp_min(col[:, 0], tiny))
        L[:, k:, k] = col * d[:, None]
        dinv[:, k] = d
    L.diagonal(dim1=1, dim2=2).copy_(1.0 / dinv)
    return L


def gram_f32_reference(A):
    return A.transpose(1, 2) @ A


def chol_linv_f32_reference(G, tiny=1e-12, mul_right=None):
    L = _chol_clamped(G, tiny)
    rhs = (torch.eye(G.shape[1], dtype=G.dtype, device=G.device).expand(
        G.shape) if mul_right is None else mul_right)
    # contiguous, as the kernel's output is (the next kernel reads it)
    return torch.linalg.solve_triangular(L, rhs, upper=False).contiguous()


def round2_gram_f32_reference(A, Li):
    Q = A @ Li.transpose(1, 2)
    return Q.transpose(1, 2) @ Q


def prec_apply_f32_reference(Lc, v):
    u = torch.einsum("bij,bj->bi", Lc, v)
    return torch.einsum("bij,bi->bj", Lc, u)


# ---------------------------------------------------------------------------
# CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------
# the kernels with two bodies, chosen by ``path=``
_PATHS = ("gram_f32", "round2_gram_f32", "prec_apply_f32")


def _bind(lib):
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    lib.gram_f32_launch.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    lib.round2_gram_f32_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
    lib.chol_linv_f32_launch.argtypes = [vp, vp, vp, vp, ci, ci, cf, vp]
    lib.prec_apply_f32_launch.argtypes = [vp, vp, vp, vp, ci, ci, vp]
    for name in ("gram_f32", "round2_gram_f32", "chol_linv_f32",
                 "prec_apply_f32"):
        getattr(lib, f"{name}_launch").restype = ci
        f = getattr(lib, f"{name}_workspace_floats")
        f.argtypes, f.restype = [ci], ll
    lib.cholqr_occupancy.argtypes = [
        ci, ci, ctypes.POINTER(ll), ctypes.POINTER(ci), ctypes.POINTER(ci),
        ctypes.POINTER(ci), ctypes.POINTER(ll)]
    lib.cholqr_occupancy.restype = ci
    lib.gram_f32_path_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
    lib.round2_gram_f32_path_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                                ci, vp]
    lib.prec_apply_f32_path_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                               vp]
    for name in _PATHS:
        getattr(lib, f"{name}_path_launch").restype = ci
        f = getattr(lib, f"{name}_path")
        f.argtypes, f.restype = [ci], ci
        f = getattr(lib, f"{name}_occupancy")
        f.argtypes = [ci, ci, ctypes.POINTER(ll), ctypes.POINTER(ci),
                      ctypes.POINTER(ci), ctypes.POINTER(ci),
                      ctypes.POINTER(ll)]
        f.restype = ci


library = CudaLibrary("cholqr", _bind)


def _shape(name, x, ndim):
    """x's shape, after checking its number of dimensions."""
    if x.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got "
                         f"{tuple(x.shape)}")
    return tuple(x.shape)


def _launch(wrapper, what, fn, *args):
    """Launch on the stream of the first argument's device; the caller
    holds that device current (``torch.cuda.device``) around this call and
    around every library query that sizes the launch, since the library
    reads the current device."""
    err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in args], stream(args[0].device))
    check_launch(err, what)
    wrapper.launches += 1


def _workspace(lib, name, B, n, device):
    """The per-node device workspace of kernel ``name`` at width n, or
    None where a node fits in shared memory."""
    floats = getattr(lib, f"{name}_workspace_floats")(n)
    return torch.empty(B * floats, dtype=_F32, device=device) if floats \
        else None


def occupancy(name, n, path=0):
    """The launch of kernel ``name`` at width n on the current card
    (``cuda_lib.occupancy``); for gram_f32, round2_gram_f32 and
    prec_apply_f32, of their body ``path`` (0: the default)."""
    lib = library.get()
    if name in _PATHS:
        return cuda_lib.occupancy(getattr(lib, f"{name}_occupancy"),
                                  f"{name} occupancy query (n={n}, "
                                  f"path={path})", n, path)
    if name != "chol_linv_f32":
        raise ValueError(f"no cholqr kernel named {name!r}")
    # chol_linv's id in the library's cholqr_occupancy is 2
    return cuda_lib.occupancy(lib.cholqr_occupancy,
                              f"{name} occupancy query (n={n})", 2, n)


def gram_f32(A, path=0):
    """(B, m, n) float32 -> (B, n, n) Gram matrices A_b^T A_b.  ``path``
    picks the kernel's body: 0 the default, 1 shared memory (or the
    workspace), 2 registers (raises past n = 76)."""
    B, m, n = _shape("A", A, 3)
    check_tensor("A", A, (B, m, n), _F32, A.device)
    if not on_card(A, "gram_f32"):
        return gram_f32_reference(A)
    out = torch.empty((B, n, n), dtype=_F32, device=A.device)
    if B:
        with torch.cuda.device(A.device):
            lib = library.get()
            path = path or lib.gram_f32_path(n)
            ws = _workspace(lib, "gram_f32", B, n, A.device) if path == 1 \
                else None
            _launch(gram_f32, f"gram_f32 (B={B}, m={m}, n={n}, path={path})",
                    lib.gram_f32_path_launch, A, out, ws, B, m, n, path)
    return out


def chol_linv_f32(G, tiny=1e-12, mul_right=None):
    """(B, n, n) SPD float32 -> L^-1 with G = L L^T, or L^-1 @ mul_right
    when that (B, n, n) lower-triangular float32 is given (the kernel
    does not read its upper triangle); pivots clamped at ``tiny``."""
    B, n, _ = _shape("G", G, 3)
    check_tensor("G", G, (B, n, n), _F32, G.device)
    if mul_right is not None:
        check_tensor("mul_right", mul_right, G.shape, _F32, G.device)
    if not on_card(G, "chol_linv_f32"):
        return chol_linv_f32_reference(G, tiny, mul_right)
    out = torch.empty((B, n, n), dtype=_F32, device=G.device)
    if B:
        with torch.cuda.device(G.device):
            lib = library.get()
            _launch(chol_linv_f32, f"chol_linv_f32 (B={B}, n={n}, "
                                   f"mul_right={mul_right is not None})",
                    lib.chol_linv_f32_launch, G, mul_right, out,
                    _workspace(lib, "chol_linv_f32", B, n, G.device), B, n,
                    float(tiny))
    return out


def round2_gram_f32(A, Li, path=0):
    """(B, m, n), (B, n, n) lower-triangular float32 -> (A Li^T)^T (A Li^T),
    (B, n, n); the kernel's register body does not read Li's upper
    triangle.  ``path`` picks the kernel's body: 0 the default, 1 shared
    memory (or the workspace), 2 registers (raises past n = 76)."""
    B, m, n = _shape("A", A, 3)
    check_tensor("A", A, (B, m, n), _F32, A.device)
    check_tensor("Li", Li, (B, n, n), _F32, A.device)
    if not on_card(A, "round2_gram_f32"):
        return round2_gram_f32_reference(A, Li)
    out = torch.empty((B, n, n), dtype=_F32, device=A.device)
    if B:
        with torch.cuda.device(A.device):
            lib = library.get()
            path = path or lib.round2_gram_f32_path(n)
            ws = _workspace(lib, "round2_gram_f32", B, n, A.device) \
                if path == 1 else None
            _launch(round2_gram_f32, f"round2_gram_f32 (B={B}, m={m}, n={n}, "
                                     f"path={path})",
                    lib.round2_gram_f32_path_launch, A, Li, out, ws, B, m, n,
                    path)
    return out


def prec_apply_f32(Lc, v, path=0):
    """(B, n, n) lower-triangular, (B, n) float32 -> Lc^T (Lc v), (B, n);
    the kernel does not read Lc's upper triangle.  ``path`` picks the
    kernel's body: 0 the default, 1 a block a node in shared memory (or
    the workspace), 2 a warp a node (raises past n = 128)."""
    B, n, _ = _shape("Lc", Lc, 3)
    check_tensor("Lc", Lc, (B, n, n), _F32, Lc.device)
    check_tensor("v", v, (B, n), _F32, Lc.device)
    if not on_card(Lc, "prec_apply_f32"):
        return prec_apply_f32_reference(Lc, v)
    out = torch.empty((B, n), dtype=_F32, device=Lc.device)
    if B:
        with torch.cuda.device(Lc.device):
            lib = library.get()
            path = path or lib.prec_apply_f32_path(n)
            ws = _workspace(lib, "prec_apply_f32", B, n, Lc.device) \
                if path == 1 else None
            _launch(prec_apply_f32, f"prec_apply_f32 (B={B}, n={n}, "
                                    f"path={path})",
                    lib.prec_apply_f32_path_launch, Lc, v, out, ws, B, n, path)
    return out


for _w in (gram_f32, chol_linv_f32, round2_gram_f32, prec_apply_f32):
    _w.launches = 0

# The four pieces, in the order cholqr_factors and the solve take them:
# the wrappers (kernels on the card), and the plain versions
KERNELS = (gram_f32, chol_linv_f32, round2_gram_f32, prec_apply_f32)
PLAIN = (gram_f32_reference, chol_linv_f32_reference,
         round2_gram_f32_reference, prec_apply_f32_reference)


# ---------------------------------------------------------------------------
# The preconditioner they compose
# ---------------------------------------------------------------------------
def cholqr_factors(A, pieces, tiny=1e-12, shift=1.5e-5, rounds=2):
    """The float32 shifted-CholeskyQR2 preconditioner of the dense float64
    systems A (B, m, n), built from ``pieces`` (KERNELS or PLAIN) as
    ninpol_tpu's unfused route builds it (gls.py:620-648): column
    equilibration D, G1 = As^T As + diag(dead + shift), Li1 = L1^-1,
    G2 = (As Li1^T)^T (As Li1^T) + diag(dead), and the combined factor
    Lc = L2^-1 Li1, so M = D Lc^T Lc D.  ``sick`` flags a clamped pivot in
    either round: max(|diag Li1|, |diag Lc|) > SICK_DINV, or not finite (a
    clamped pivot can overflow the factor).  ``rounds`` < 2 stops after
    the first round, as ninpol_tpu's fused kernel does
    (pallas_chol.py:643-669): Lc = Li1 and G2 = None, ``sick`` from Li1
    alone.  Returns every stage, keyed by name."""
    gram, chol_linv, round2, _ = pieces
    n = A.shape[2]
    A32 = A.to(_F32)
    d2 = torch.sum(A32 * A32, dim=1)
    dead = d2 == 0
    D = torch.where(dead, 0.0, torch.rsqrt(torch.where(dead, 1.0, d2)))
    As = A32 * D[:, None, :]
    eye = torch.eye(n, dtype=_F32, device=A.device)
    deadf = dead.to(_F32)
    G1 = gram(As) + eye * (deadf + shift)[:, :, None]
    Li1 = chol_linv(G1, tiny)
    dmax = Li1.diagonal(dim1=1, dim2=2).abs().amax(dim=1)
    if rounds < 2:
        G2, Lc = None, Li1
    else:
        G2 = round2(As, Li1) + eye * deadf[:, :, None]
        Lc = chol_linv(G2, tiny, mul_right=Li1)
        dmax = torch.maximum(dmax,
                             Lc.diagonal(dim1=1, dim2=2).abs().amax(dim=1))
    return dict(D=D, As=As, G1=G1, Li1=Li1, G2=G2, Lc=Lc,
                sick=~(dmax <= SICK_DINV))
