"""Float64 Householder triangularization: the exact least-squares solve of
the GLS fallback path, and the plain version of the ``qr_r`` kernel."""
from __future__ import annotations

import torch


def householder_sweep(R, n_cols):
    """Triangularize columns [0, n_cols) of R (B, m, c) in place with
    Householder reflectors, applied to all c columns; returns R.

    Reflector k: x = R[k:, k], v = x - sgn ||x|| e_k with sgn = -1 where
    x_k >= 0 (so R[k, k] = -||x|| there), beta = 2 / ||v||^2 (0 where
    v = 0), R -= beta v (v^T R).  O(n_cols) sequential batched rank-1
    updates.  Below the diagonal of the swept columns R keeps rounding
    residue, not zeros."""
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
