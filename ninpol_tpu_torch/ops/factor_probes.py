"""Kernel 1's factorization probes: four hand-written CUDA kernels
(``csrc/factor_probes.cu``), their wrappers and their plain PyTorch
versions.  Design alternatives for the two factorizations of the fused
solve kernel, counterparts of the TPU probes in the repo's tools/; no
route runs them (``tools/factor_probes.py`` times them on the route's
inputs):

  chol_factor(G, tiny, smem_bytes)   (B,n,n) -> (B,n,n)
        L of G = L L^T, lower triangular, every pivot clamped at
        ``tiny`` as chol_linv_f32's: its diagonal is 1/dinv, dinv =
        rsqrt(max(pivot, tiny)); no inverse (trisolve_probe.py:79); by
        chol_linv_tc's blocked factor (panels of 16, FP64 tensor cores)
  chol_trsm_gram(A, G, tiny, width, smem_bytes)
                                     (B,m,n), (B,n,n) -> (B,n,n)
        X X^T with X = L^-1 A^T by forward substitution, never forming
        L^-1 (trsm_probe.py:129, :192): the substitution and X X^T as
        FP64 tensor-core products, G factored by the elimination
        (``width`` 0, the probe's variant B) or by chol_linv_tc's
        blocked factor with panels of ``width`` 8, 16 or 32 (variant C)
  chol_linv_tc(G, tiny, width, smem_bytes, mul_right)
                                     (B,n,n) [, (B,n,n)] -> (B,n,n)
        L^-1, as chol_linv_f32(G), by a blocked factor, 8 columns a
        step, right-looking by panels of ``width`` (8, 16, 32, 48), its
        products and L^-1's blocks on FP64 tensor cores
        (chol_mxu_probe.py:73); with ``mul_right`` = P, lower
        triangular, L^-1 P, as chol_linv_f32(G, mul_right=P): the
        route's chol2, Lc = L2^-1 L1^-1 (trisolve_probe.py:95), the
        product of the two triangles on the same tensor cores
  chol_trisolve_apply(G, Li, v, tiny, applies, block, smem_bytes)
                                     (B,n,n), (B,n,n), (B,n) -> (B,n)
        ``applies`` times v <- Li^T L^-T L^-1 Li v with G = L L^T, by two
        triangular solves an apply (trisolve_probe.py:162); = applies
        times prec_apply_f32(L^-1 Li, v).  L by chol_factor's blocked
        factor; ``block`` 1 solves pivot by pivot on one warp (the TPU
        probe's sweep), 8 by blocks of 8 rows on all 8 warps through the
        factor's inverted diagonal blocks.  Li is read as lower
        triangular, as the route's L1^-1 is; ``applies`` = 0 gives v

All float32 in and out, natural (node, row, column) layout, any B; the
kernels take n <= 80 (chol_trsm_gram any m whose X fits in shared
memory, chol_linv_tc any n whose two padded matrices do) and raise past
that.  Each wrapper runs its plain version for CPU tensors and launches
its kernel (built with nvcc on first use, in a library of its own) for
CUDA tensors, or raises; ``<wrapper>.launches`` counts kernel launches,
``<wrapper>.launches_by`` the same by the instance's ``width`` or
``block`` (None for chol_factor; ("mul_right", width) for chol_linv_tc
with a right factor).  ``smem_bytes`` requests that much dynamic shared
memory a block (at least what the instance needs), to run at another
kernel's occupancy (kernel 1's: ops/gls_solve.py::occupancy).
``occupancy(name, m, n, ..., smem_bytes=, mul_right=)`` gives a launch's
registers, spills, shared memory and blocks an SM.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from . import cuda_lib
from .cholqr import _chol_clamped, chol_linv_f32_reference
from .cuda_lib import (CudaLibrary, check_launch, check_request, check_tensor,
                       on_card, stream)

_F32 = torch.float32
# chol_trsm_gram's factors: 0 the elimination, else a panel width
TRSM_WIDTHS = (0, 8, 16, 32)
LINV_TC_WIDTHS = (8, 16, 32, 48)
# chol_trisolve_apply's solves: rows a block
TRISOLVE_BLOCKS = (1, 8)
# the probes' ids in the library's factor_probes_occupancy
_IDS = {"chol_factor": 0, "chol_trsm_gram": 1, "chol_linv_tc": 2,
        "chol_trisolve_apply": 3}
_RIGHT_ID = 4   # chol_linv_tc with a right factor


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------
def chol_factor_reference(G, tiny=1e-12):
    return _chol_clamped(G, tiny)


def chol_trsm_gram_reference(A, G, tiny=1e-12):
    L = _chol_clamped(G, tiny)
    X = torch.linalg.solve_triangular(L, A.transpose(1, 2), upper=False)
    return X @ X.transpose(1, 2)


def chol_linv_tc_reference(G, tiny=1e-12, mul_right=None):
    return chol_linv_f32_reference(G, tiny, mul_right)


def chol_trisolve_apply_reference(G, Li, v, tiny=1e-12, applies=4):
    L = _chol_clamped(G, tiny)
    for _ in range(applies):
        u = torch.einsum("bij,bj->bi", Li, v)[:, :, None]
        x = torch.linalg.solve_triangular(L, u, upper=False)
        y = torch.linalg.solve_triangular(L.transpose(1, 2), x, upper=True)
        v = torch.einsum("bij,bi->bj", Li, y[:, :, 0])
    return v


# ---------------------------------------------------------------------------
# CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------
def _bind(lib):
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    lib.chol_factor_launch.argtypes = [vp, vp, ci, ci, cf, ll, vp]
    lib.chol_trsm_gram_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, cf, ll,
                                          vp]
    lib.chol_linv_tc_launch.argtypes = [vp, vp, vp, ci, ci, ci, cf, ll, vp]
    lib.chol_trisolve_apply_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                               ci, cf, ll, vp]
    for name in _IDS:
        getattr(lib, f"{name}_launch").restype = ci
    lib.factor_probes_occupancy.argtypes = [
        ci, ci, ci, ci, ll, ctypes.POINTER(ll), ctypes.POINTER(ci),
        ctypes.POINTER(ci), ctypes.POINTER(ci), ctypes.POINTER(ll)]
    lib.factor_probes_occupancy.restype = ci


library = CudaLibrary("factor_probes", _bind)


def _square(name, x):
    if x.dim() != 3 or x.shape[1] != x.shape[2]:
        raise ValueError(f"{name} must be (B, n, n), got {tuple(x.shape)}")
    return x.shape[0], x.shape[1]


def _launch(wrapper, instance, what, fn, *args):
    """Launch under the first tensor's device guard, on its stream (the
    library reads the current device when it sizes the launch), and count
    it for the wrapper and its ``instance`` (its width or block)."""
    device = args[0].device
    with torch.cuda.device(device):
        fn = getattr(library.get(), fn)
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args], stream(device))
    check_launch(err, what)
    wrapper.launches += 1
    wrapper.launches_by[instance] += 1


def occupancy(name, m, n, width=0, block=None, smem_bytes=0,
              mul_right=False):
    """The launch of probe ``name`` at (m, n) with the wrapper's
    ``width`` or ``block`` and a shared memory request of ``smem_bytes``
    on the current card (``cuda_lib.occupancy``); ``mul_right``:
    chol_linv_tc's instance with a right factor."""
    width = block if block is not None else width
    probe = _RIGHT_ID if mul_right else _IDS[name]
    return cuda_lib.occupancy(library.get().factor_probes_occupancy,
                              f"{name} occupancy query (m={m}, n={n}, "
                              f"width={width}, smem={smem_bytes}, "
                              f"mul_right={bool(mul_right)})",
                              probe, m, n, width, int(smem_bytes))


def chol_factor(G, tiny=1e-12, smem_bytes=0):
    """(B, n, n) SPD float32 -> its clamped Cholesky factor L; at least
    ``smem_bytes`` of shared memory a block."""
    check_request(smem_bytes)
    B, n = _square("G", G)
    check_tensor("G", G, (B, n, n), _F32, G.device)
    if not on_card(G, "chol_factor"):
        return chol_factor_reference(G, tiny)
    out = torch.empty_like(G)
    if B:
        _launch(chol_factor, None, f"chol_factor (B={B}, n={n})",
                "chol_factor_launch", G, out, B, n, float(tiny),
                int(smem_bytes))
    return out


def chol_trsm_gram(A, G, tiny=1e-12, width=0, smem_bytes=0):
    """(B, m, n), (B, n, n) SPD float32 -> X X^T, X = L^-1 A^T, G = L L^T,
    the products on tensor cores, G factored by the elimination (``width``
    0) or by tensor-core panels of ``width`` 8, 16 or 32; at least
    ``smem_bytes`` of shared memory a block."""
    if width not in TRSM_WIDTHS:
        raise ValueError(f"width must be one of {TRSM_WIDTHS}, got {width}")
    check_request(smem_bytes)
    B, n = _square("G", G)
    m = A.shape[1] if A.dim() == 3 else -1
    check_tensor("A", A, (B, m, n), _F32, G.device)
    check_tensor("G", G, (B, n, n), _F32, G.device)
    if not on_card(G, "chol_trsm_gram"):
        return chol_trsm_gram_reference(A, G, tiny)
    out = torch.empty_like(G)
    if B:
        _launch(chol_trsm_gram, width, f"chol_trsm_gram (B={B}, m={m}, "
                                       f"n={n}, width={width})",
                "chol_trsm_gram_launch", A, G, out, B, m, n, width,
                float(tiny), int(smem_bytes))
    return out


def chol_linv_tc(G, tiny=1e-12, width=16, smem_bytes=0, mul_right=None):
    """(B, n, n) SPD float32 -> L^-1 with G = L L^T, or L^-1 @ mul_right
    when that (B, n, n) lower-triangular float32 is given (its upper
    triangle is not read), by panels of ``width`` on tensor cores; at
    least ``smem_bytes`` of shared memory a block."""
    if width not in LINV_TC_WIDTHS:
        raise ValueError(f"width must be one of {LINV_TC_WIDTHS}, got "
                         f"{width}")
    check_request(smem_bytes)
    B, n = _square("G", G)
    check_tensor("G", G, (B, n, n), _F32, G.device)
    if mul_right is not None:
        check_tensor("mul_right", mul_right, (B, n, n), _F32, G.device)
    if not on_card(G, "chol_linv_tc"):
        return chol_linv_tc_reference(G, tiny, mul_right)
    out = torch.empty_like(G)
    if B:
        right = mul_right is not None
        _launch(chol_linv_tc, ("mul_right", width) if right else width,
                f"chol_linv_tc (B={B}, n={n}, width={width}, "
                f"mul_right={right})",
                "chol_linv_tc_launch", G, mul_right, out, B, n, width,
                float(tiny), int(smem_bytes))
    return out


def chol_trisolve_apply(G, Li, v, tiny=1e-12, applies=4, block=8,
                        smem_bytes=0):
    """(B, n, n) SPD, (B, n, n) lower-triangular, (B, n) float32 ->
    ``applies`` times v <- Li^T L^-T L^-1 Li v, G = L L^T; the solves by
    blocks of ``block`` rows (1 or 8); at least ``smem_bytes`` of shared
    memory a block."""
    if block not in TRISOLVE_BLOCKS:
        raise ValueError(f"block must be one of {TRISOLVE_BLOCKS}, got "
                         f"{block}")
    check_request(smem_bytes)
    B, n = _square("G", G)
    check_tensor("G", G, (B, n, n), _F32, G.device)
    check_tensor("Li", Li, (B, n, n), _F32, G.device)
    check_tensor("v", v, (B, n), _F32, G.device)
    if applies < 0:
        raise ValueError(f"applies must be >= 0, got {applies}")
    if not on_card(G, "chol_trisolve_apply"):
        return chol_trisolve_apply_reference(G, Li, v, tiny, applies)
    out = torch.empty_like(v)
    if B:
        _launch(chol_trisolve_apply, block,
                f"chol_trisolve_apply (B={B}, n={n}, applies={applies}, "
                f"block={block})",
                "chol_trisolve_apply_launch", G, Li, v, out, B, n, applies,
                block, float(tiny), int(smem_bytes))
    return out


KERNELS = (chol_factor, chol_trsm_gram, chol_linv_tc, chol_trisolve_apply)
for _w in KERNELS:
    _w.launches = 0
    _w.launches_by = collections.Counter()
