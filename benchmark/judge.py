"""The comparison that decides ``correct``.

Three numbers, each held to a limit of its own (the configuration's
``limits``, which a traffic file may override):

  * ``weight_gap``: the widest gap between a sampled node's delivered
    weights and the plain reference's, over the node's row, as a share of
    its largest reference weight (absolute where the reference row is
    zero: Dirichlet nodes and nodes whose faces are all on the boundary).
    A weight in a column the reference has no cell for counts whole.
  * ``neumann_gap``: the same for the node's Neumann weight.
  * ``row_sum_gap``: over every node of every rebuild, |sum of weights - 1|
    where the node gets a solve (the constant column makes the exact
    weights sum to 1), and the sum of |weights| where its row must be zero.
"""
from __future__ import annotations

import numpy as np

NAMES = ("weight_gap", "neumann_gap", "row_sum_gap")


def scale(w):
    top = float(np.max(np.abs(w), initial=0.0))
    return top if top > 0 else 1.0


def dense_gaps(rows, ref):
    """Per node (weight gap, Neumann gap) of device rows (S, ncols + 1),
    [weights | Neumann weight], against the reference's (ids, w, wn)."""
    out = []
    ncols = rows.shape[1] - 1
    for row, (ids, w, wn) in zip(rows, ref):
        want = np.zeros(ncols)
        want[:len(w)] = w
        s = scale(w)
        out.append((float(np.max(np.abs(row[:ncols] - want))) / s,
                    abs(float(row[ncols]) - wn) / s))
    return out


def csr_gaps(W, nw, ref):
    """Per node (weight gap, Neumann gap) of CSR rows ``W`` (the
    reference's contract: each stored entry is the cell's weight plus the
    node's Neumann weight, zeros eliminated) and Neumann weights ``nw``."""
    out = []
    for i, (ids, w, wn) in enumerate(ref):
        a, b = W.indptr[i], W.indptr[i + 1]
        got = dict(zip(W.indices[a:b].tolist(), W.data[a:b].tolist()))
        want = dict(zip(ids.tolist(), (w + wn).tolist()))
        gap = max((abs(got.get(c, 0.0) - want.get(c, 0.0))
                   for c in set(got) | set(want)), default=0.0)
        s = scale(w)
        out.append((gap / s, abs(float(nw[i]) - wn) / s))
    return out


def row_sum_gap(sums, abs_sums, solved):
    """The row-sum number of one rebuild from each node's sum of weights,
    sum of |weights| (the Neumann weight with them) and solve mask."""
    return float(max(np.max(np.abs(sums[solved] - 1.0), initial=0.0),
                     np.max(abs_sums[~solved], initial=0.0)))


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]); a NaN or a missing number fails."""
    rows = [(n, float(numbers.get(n, float("nan"))), limits[n])
            for n in NAMES]
    return all(v <= lim for _, v, lim in rows), rows
