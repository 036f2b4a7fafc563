"""State carried across from ninpol_tpu.

ninpol has no learned weights: its "parameters" are the grid and the
loaded data.  These functions take what ninpol_tpu produces as plain
numpy and hand it to this package, so both packages can work on the same
state.  Nothing here imports JAX or ninpol_tpu.
"""
from __future__ import annotations

import numpy as np

from .interpolator import Interpolator


def from_state(d, device=None):
    """Build an Interpolator on ``device`` from the numpy dict that
    ``ninpol_tpu.Interpolator._make_cache(args)`` produces (the grid's
    constructor arguments plus the cell/point/face data and the
    variable index), the same dict its pickle cache stores."""
    interp = Interpolator(device=device)
    interp._load_cache(d)
    interp._build_grid()
    return interp


def _untile_kc(x, K):
    """(G, C*Kp, NT) component planes -> (G*NT, K, C)."""
    x = np.asarray(x)
    G, CKp, NT = x.shape
    Kp = -(-K // 8) * 8
    C = CKp // Kp
    t = x.reshape(G, C, Kp, NT)[:, :, :K, :]
    return np.transpose(t, (0, 3, 2, 1)).reshape(G * NT, K, C)


def _untile_k(x):
    """(G, K, NT) -> (G*NT, K)."""
    x = np.asarray(x)
    return np.transpose(x, (0, 2, 1)).reshape(-1, x.shape[1])


def tiles_from_reference(tiles):
    """The 12-tuple of ninpol_tpu's ``_gls_gather_fused`` (hi/lo float32
    planes in its (G, C*Kp, 128) tile layout) as this package's solve
    inputs: a dict of numpy arrays keyed like ``gls_solve``'s arguments,
    each float64 value rebuilt as hi + lo."""
    dkp, fgp, pair_t, ks_t, cv_t, fv_t, neu_t, val_t = tiles[:8]
    ks = _untile_k(ks_t).astype(np.int32)
    fv = _untile_k(fv_t) > 0
    E, F = ks.shape[1], fv.shape[1]
    dk = _untile_kc(dkp, E).astype(np.float64)
    fg = _untile_kc(fgp, F).astype(np.float64)

    def piece(i):           # hi planes i..i+2, lo planes i+3..i+5
        return fg[:, :, i:i + 3] + fg[:, :, i + 3:i + 6]

    with_neumann = fg.shape[2] == 32
    return {
        "dk": dk[:, :, 0:3] + dk[:, :, 3:6],
        "l1": piece(0), "l2": piece(6), "t1m": piece(12), "tt": piece(18),
        "lb": piece(24) if with_neumann else None,
        "nm": fg[:, :, 30] + fg[:, :, 31] if with_neumann else None,
        "pair": np.ascontiguousarray(_untile_kc(pair_t, F)).astype(np.int32),
        "ks": ks,
        "cv": _untile_k(cv_t) > 0,
        "fv": fv,
        "isneu": _untile_k(neu_t)[:, 0] > 0,
        "valid": _untile_k(val_t)[:, 0] > 0,
    }
