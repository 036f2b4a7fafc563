"""Householder triangularization: the exact float64 least-squares solve of
the GLS fallback path, the plain version of the ``qr_r`` kernel, and the
float32 preconditioner of the "refined" GLS solver
(``solve_normal_refined``)."""
from __future__ import annotations

import torch

# the refined solver's pivot clamp on R's diagonal, and its sick flag on
# |diag R^-1| (ninpol_tpu ops/solve.py:183-260)
R_PIVOT_MIN = 1e-8
SICK_RINV = 3e3


def householder_sweep(R, n_cols):
    """Triangularize columns [0, n_cols) of R (B, m, c) in place with
    Householder reflectors, applied to all c columns; returns R.

    Reflector k: x = R[k:, k], v = x - sgn ||x|| e_k with sgn = -1 where
    x_k >= 0 (so R[k, k] = -||x|| there), beta = 2 / ||v||^2 (0 where
    v = 0), R -= beta v (v^T R).  O(n_cols) sequential batched rank-1
    updates, in R's dtype (float64 on the exact path, float32 in the
    refined solver).  Below the diagonal of the swept columns R keeps
    rounding residue, not zeros."""
    m = R.shape[1]
    rows = torch.arange(m, device=R.device)
    for k in range(n_cols):
        x = torch.where((rows >= k)[None, :], R[:, :, k], 0.0)
        xk = x[:, k]
        normx = torch.sqrt(torch.sum(x * x, dim=1))
        alpha = torch.where(xk >= 0, -normx, normx)
        v = x.clone()
        v[:, k] = xk - alpha
        vnorm2 = torch.sum(v * v, dim=1)
        beta = torch.where(vnorm2 > 0, 2.0 / torch.where(vnorm2 > 0, vnorm2, 1.0),
                           0.0)
        w = torch.einsum("bm,bmn->bn", v, R)
        R -= beta[:, None, None] * v[:, :, None] * w[:, None, :]
    return R


def householder_lastrow(Aug, n_cols):
    """Float64 Householder triangularization of augmented [A|B] (B, m, n+r);
    returns the last LS-solution row (B, r) = R[n-1, n:]/R[n-1, n-1].

    For an upper-triangular R the last row of R11^-1 is e_n^T/R[n-1,n-1],
    so the full triangular solve is unnecessary.  Matches LAPACK ``dgels``
    up to rounding (counterpart of
    ninpol_tpu/ops/solve.py::householder_lastrow).
    """
    R = householder_sweep(Aug.clone(), n_cols)
    denom = R[:, n_cols - 1, n_cols - 1]
    denom = torch.where(denom == 0, 1.0, denom)
    return R[:, n_cols - 1, n_cols:] / denom[:, None]


def solve_normal_refined(A, b, mul_G, n_refine=2):
    """Mixed-precision solve of (A^T A) y = b, ninpol_tpu's "refined" GLS
    solver (``solve_normal_refined_ops``, its ops/solve.py:219-280): a
    float32 Householder R of the column-equilibrated A, with an identity
    row appended for each dead (all-zero) column, preconditions
    ``n_refine`` float64 refinement sweeps y += M (b - mul_G(y)),
    M r = D R^-1 R^-T (D r), R^-1 R^-T in float32.

    ``A`` (B, m, n) is the float64 system, of which only its float32
    rounding is read; ``mul_G(y)`` is A^T (A y) in float64.  R's pivots
    are clamped to |d| >= R_PIVOT_MIN, and a node with max |diag R^-1| >
    SICK_RINV (R^-1's diagonal is 1 / the clamped pivot) is flagged sick.
    Returns y, with dead columns zeroed, and the error estimate
    ||dy|| / ||y|| of the last sweep (0 without a sweep), 1 on a sick
    node.  ninpol_tpu inverts R by a power-of-two block recursion (a TPU
    matmul idiom); here a triangular solve gives the same inverse."""
    f32, f64 = torch.float32, torch.float64
    B, _, n = A.shape
    A32 = A.to(f32)
    d2 = torch.einsum("bmn,bmn->bn", A32, A32)
    dead = d2 == 0
    D32 = torch.where(dead, 0.0, torch.rsqrt(torch.where(dead, 1.0, d2)))
    D = D32.to(f64)
    eye = torch.eye(n, dtype=f32, device=A.device)
    As = torch.cat([A32 * D32[:, None, :], eye * dead[:, None, :].to(f32)],
                   dim=1)
    R = torch.triu(householder_sweep(As, n)[:, :n, :n])
    d = R.diagonal(dim1=1, dim2=2)
    dc = torch.where(d.abs() < R_PIVOT_MIN,
                     torch.where(d < 0, -R_PIVOT_MIN, R_PIVOT_MIN), d)
    d.copy_(dc)
    Rinv = torch.linalg.solve_triangular(R, eye.expand(B, n, n), upper=True)
    sick = (1.0 / dc).abs().amax(dim=1) > SICK_RINV

    def M(r):
        rs = (r * D).to(f32)
        t = torch.einsum("bkn,bk->bn", Rinv, rs)       # R^-T rs
        return torch.einsum("bnk,bk->bn", Rinv, t).to(f64) * D

    y = M(b)
    dy2 = torch.zeros(B, dtype=f64, device=A.device)
    for _ in range(n_refine):
        dy = M(b - mul_G(y))
        y = y + dy
        dy2 = torch.sum(dy * dy, dim=1)
    y = torch.where(dead, 0.0, y)
    err = torch.sqrt(dy2) / torch.clamp_min(
        torch.linalg.vector_norm(y, dim=1), 1e-300)
    return y, torch.where(sick, 1.0, err)
