"""Plain reference of GLS node weights (NumPy assembly, LAPACK dgels).

The upstream method (ninpol gls.pyx:75-474; the per-node oracle of the
repository's tests): for node v with cells K (ascending ids) and faces S,
an m x n system with one cell row [x_K - x_v | 1] per cell (unit right-hand
side), three rows per interior face (normal-flux continuity -K1 N | K2 N,
tangential continuity -T1 | T1, weighted tangential -tau T2 | tau T2 with
T1 = x_v - x_S, T2 = N x T1, tau = |T2|^-eta, eta the larger diff_mag of the
two cells) and, at a Neumann node, one row -K N per boundary face with the
mean Neumann value of the face's points on the right.  The weights are the
last row of the least-squares solution; the Neumann weight is the last
cell's (the upstream's column w_total - 1).  Dirichlet boundary nodes and
nodes whose faces are all on the boundary get zeros.

Everything is worked out again here from the mesh's points and cells, the
permeability and the boundary data the benchmark made: cells around a
node, its faces, which cell defines a face (the lower id, in whose local
order the normal is taken with the upstream's float32 intermediates),
centres, normals and diff_mag.  It imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

from ..yardstick import topology
from ..yardstick.problem import diff_mag


def cells_around(cells, nodes):
    """{node: ascending ids of the cells that hold it} for ``nodes``."""
    ci, cj = np.nonzero(np.isin(cells, nodes))
    pt = cells[ci, cj]
    order = np.lexsort((ci, pt))
    pt, ci = pt[order], ci[order]
    cut = np.flatnonzero(np.diff(pt)) + 1
    return {int(p[0]): c for p, c in zip(np.split(pt, cut),
                                           np.split(ci, cut))}


def node_system(v, K_ids, points, cells, cell_types, perm, nflag, nval):
    """The upstream system of node ``v`` (M, rhs), or None where the node
    gets zero weights.  ``perm`` (E, 9) is the permeability of ``K_ids``;
    ``cell_types`` is one type name for all cells or a name per cell."""
    E = len(K_ids)
    names = (np.full(E, cell_types) if isinstance(cell_types, str)
             else np.asarray(cell_types)[K_ids])
    hf, owner = [], []
    for name in np.unique(names):
        idx = np.flatnonzero(names == name)
        lf = np.asarray(topology.LOCAL_FACES[name])
        c = cells[K_ids[idx]]
        hf.append(np.where(lf[None] >= 0, c[:, np.maximum(lf, 0)],
                           -1).reshape(-1, 4))
        owner.append(np.repeat(idx, len(lf)))
    hf, owner = np.concatenate(hf), np.concatenate(owner)
    keep = (hf == v).any(axis=1)
    hf, owner = hf[keep], owner[keep]
    key = np.sort(np.where(hf >= 0, hf, len(points)), axis=1)[:, :3]
    # group half-faces by face; the first of a group (lower local cell
    # index, so lower cell id) defines the face
    order = np.lexsort((owner, key[:, 2], key[:, 1], key[:, 0]))
    key, hf, owner = key[order], hf[order], owner[order]
    new = np.ones(len(hf), bool)
    new[1:] = (key[1:] != key[:-1]).any(axis=1)
    first = np.flatnonzero(new)
    size = np.diff(np.append(first, len(hf)))
    interior = size == 2
    n_face, n_bface = len(first), int(np.sum(~interior))
    is_neu = nflag[v] > 0
    if (n_bface > 0 and not is_neu) or n_bface >= n_face:
        return None
    fpts = hf[first]
    Nf = topology.face_normals(points, fpts)
    xS = topology.face_centers(points, fpts)
    xv = points[v]
    cent = topology.cell_centres(points, cells[K_ids])
    Kc = np.reshape(perm, (E, 3, 3))
    dm = diff_mag(perm)

    n_int = int(interior.sum())
    rows = E + 3 * n_int + (n_bface if is_neu else 0)
    n = 3 * E + 1
    M = np.zeros((rows, n))
    rhs = np.zeros((rows, E + int(is_neu)))
    M[np.arange(E)[:, None], 3 * np.arange(E)[:, None] + np.arange(3)] = (
        cent - xv)
    M[:E, n - 1] = 1.0
    rhs[np.arange(E), np.arange(E)] = 1.0

    i1 = owner[first]
    i2 = owner[np.minimum(first + 1, len(hf) - 1)]
    fi = np.flatnonzero(interior)
    a, b = i1[fi], i2[fi]
    N = Nf[fi]
    T1 = xv - xS[fi]
    T2 = np.cross(N, T1)
    eta = np.maximum(dm[a], dm[b])
    tau = np.sqrt(np.sum(T2 ** 2, axis=1)) ** (-eta)
    nL1 = np.einsum("fij,fj->fi", Kc[a], N)
    nL2 = np.einsum("fij,fj->fi", Kc[b], N)
    r = E + 3 * np.arange(n_int)
    c3 = np.arange(3)
    for off, va, vb in ((0, -nL1, nL2), (1, -T1, T1),
                        (2, -tau[:, None] * T2, tau[:, None] * T2)):
        M[(r + off)[:, None], 3 * a[:, None] + c3] = va
        M[(r + off)[:, None], 3 * b[:, None] + c3] = vb
    if is_neu:
        fb = np.flatnonzero(~interior)
        ob = i1[fb]
        rb = E + 3 * n_int + np.arange(n_bface)
        M[rb[:, None], 3 * ob[:, None] + c3] = -np.einsum(
            "fij,fj->fi", Kc[ob], Nf[fb])
        bp = fpts[fb]
        on = bp >= 0
        rhs[rb, E] = (np.where(on, nval[np.maximum(bp, 0)], 0).sum(axis=1)
                      / on.sum(axis=1))
    return M, rhs


def solve_last_rows(systems, dtype=torch.float64):
    """The last solution row of each least-squares system (M, rhs), by
    LAPACK dgels on the CPU in ``dtype``, systems of one shape batched."""
    out = [None] * len(systems)
    shapes = {}
    for i, (M, rhs) in enumerate(systems):
        shapes.setdefault((M.shape, rhs.shape), []).append(i)
    for idx in shapes.values():
        A = torch.as_tensor(np.stack([systems[i][0] for i in idx]),
                            dtype=dtype)
        B = torch.as_tensor(np.stack([systems[i][1] for i in idx]),
                            dtype=dtype)
        X = torch.linalg.lstsq(A, B, driver="gels").solution
        last = X[:, -1, :].to(torch.float64).numpy()
        for k, i in enumerate(idx):
            out[i] = last[k]
    return out


def gls_weights(points, cells, cell_types, nodes, around, perm_of, nflag,
                nval, dtype=torch.float64):
    """Reference weights of ``nodes``: a list of (cell ids ascending,
    weights, Neumann weight).  ``cells`` are -1 padded where the types
    differ; ``around`` is ``cells_around`` of (at least) these nodes,
    ``perm_of(cell_ids)`` the cells' permeability (k, 9), ``dtype`` the
    precision of the solve."""
    systems, where = [], []
    out = []
    for v in nodes:
        K_ids = around[int(v)]
        s = node_system(int(v), K_ids, points, cells, cell_types,
                        perm_of(K_ids), nflag, nval)
        out.append([K_ids, np.zeros(len(K_ids)), 0.0])
        if s is not None:
            systems.append(s)
            where.append(len(out) - 1)
    for i, last in zip(where, solve_last_rows(systems, dtype)):
        E = len(out[i][0])
        out[i][1] = last[:E]
        if last.shape[0] > E:        # a Neumann node
            out[i][2] = last[E - 1]
    return out
