"""GLS (Generalized Least Squares) MPFA-D node interpolation on PyTorch.

Counterpart of ninpol_tpu/_methods/gls.py, itself a rebuild of the
reference method (ninpol/_methods/gls.pyx:38-474).  Per node v the
reference assembles an m x n constraint matrix and solves it with LAPACK
dgels, keeping only the LAST solution row:

  * one "cell row" per surrounding cell K: [dKv | 1], unit RHS;
  * three "flux rows" per interior face S: normal-flux continuity
    (-K1 N at cell 1, +K2 N at cell 2), tangential continuity T1, and
    weighted tangential tau*T2 with tau = ||T2||^(-eta), eta = max
    diff_mag of the two cells;
  * one Neumann row per boundary face of a Neumann node: -K N at the
    owner cell, RHS = mean Neumann value of the face's points.

With the constant column last, the weights are the cell rows of A y where
y solves (A^T A) y = e_n: one SPD solve per node.  Nodes are sorted into
(E, F) stencil classes (DeviceGrid.buckets); for each chunk of a class the
stencils are gathered and the geometric pieces computed in float64
(``gls_gather``), the solve runs, and the epilogue masks the outputs.  The
solve is the fused kernel (ops/gls_solve.py) or, with
``GLSInterpolation.fused = False``, ``gls_solve_unfused``: the same
shifted-CholeskyQR2 algorithm composed from the four kernels of
ops/cholqr.py and float64 torch ops (ninpol_tpu's unfused route).  With
``GLSInterpolation.solver = "pallas"`` it is ``gls_solve_csne``, the
cross-check route: a Householder R of A and the corrected semi-normal
equations (the two kernels of ops/qr.py).  Any other solver name is
ninpol_tpu's "refined" route, ``gls_solve_refined``: a float32 Householder
R of the equilibrated A preconditions float64 refinement sweeps (torch
ops: ninpol_tpu has no Pallas kernel for it).  On a mesh
(parallel/sharding.py) each class's nodes are split over the shards and
every chunk runs on its shard's device (``solve_class``).
Nodes whose convergence estimate rnorm is not provably below
``fallback_tol`` are re-solved exactly (float64 Householder, ``gls_exact``).

Reference quirks reproduced (neumann_compat=True, default):
  * the returned Neumann weight is the last *cell* weight (gls.pyx:470-472
    reads column w_total-1); neumann_compat=False returns the true
    Neumann-column weight;
  * nodes with n_bface >= n_face skip assembly (gls.pyx:266-267); here
    such nodes yield zero weights.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import face_table as face_ops
from ..ops import qr
from ..ops.cholqr import KERNELS
from ..ops.gls_solve import (assemble, cholqr2_solve, gls_solve, incidence,
                             mul_G, node_active, solve_outputs)
from ..ops.solve import householder_lastrow, solve_normal_refined
from ..parallel.sharding import (Replicated, as_mesh, local, schedule,
                                 to_device)
from ..utils.tracing import PREFIX, children, count, span, to_host, upload

# Solve-kernel chunks hold at most this many system-matrix elements
# (B * m * n): it bounds the gathered inputs and the plain version's dense
# working set.
CHUNK_ELEMS = int(4.6e8)
# Exact-path chunk: its float64 Householder working set is
# B * (m + 3E) * (n + E + 1) elements.
EXACT_CHUNK = 2048

# spans of solve_class, one each per chunk (the counterparts of the
# jitted gather, solve and epilogue programs a ninpol_tpu trace names; a
# trace reader looks for these names)
GATHER_RANGE = PREFIX + "gls_gather"
SOLVE_RANGE = PREFIX + "gls_solve"
EPILOGUE_RANGE = PREFIX + "gls_epilogue"
EXACT_RANGE = PREFIX + "gls_exact"
# the face table's two parts: the copies of its per-cell and per-point
# inputs to the device, then its build there
FACE_UPLOAD = PREFIX + "face_upload"
FACE_BUILD = PREFIX + "face_build"
# prepare()'s span and its phases, each with its name on the
# NINPOL_TPU_PHASES line (ninpol_tpu's names, marks at each phase's end)
PREPARE = PREFIX + "prepare"
FACE_TABLE = PREFIX + "face_table"
CLASS_PLAN = PREFIX + "class_plan"
DISPATCH = PREFIX + "dispatch"
N_BAD_SYNC = PREFIX + "n_bad_sync"
EXACT_FALLBACK = PREFIX + "exact_fallback"
HOST_WRITE = PREFIX + "host_write"
PHASE_MARKS = {FACE_TABLE: "face_cache", CLASS_PLAN: "bucket_plan",
               DISPATCH: "dispatch", N_BAD_SYNC: "n_bad_sync(n_bad={n_bad})",
               EXACT_FALLBACK: "exact_fallback", HOST_WRITE: "host_write"}


def build_face_table(dgrid, perm, diff_mag, neumann_val, neumann_flag):
    """The face table, (n_faces, 14) float64, one row per face: [0:3]
    normal, [3:6] center, [6:9] K N of the first cell, [9:12] of the
    second, [12] eta, [13] the face's mean Neumann value
    (ops/face_table.py), built on each device from the face geometry
    the grid holds there and the per-cell K and diff_mag and per-point
    Neumann values copied to it; and the points' Neumann flags.  Both
    are placed as the grid's arrays are (``DeviceGrid.map_rows``,
    ``DeviceGrid.place``)."""
    n, p = dgrid.n_elems, dgrid.n_points
    host = [np.asarray(perm, np.float64).reshape(-1)[:9 * n],
            np.asarray(diff_mag, np.float64).reshape(-1)[:n],
            np.asarray(neumann_val, np.float64).reshape(-1)[:p]]
    with span(FACE_UPLOAD):
        # every device gathers any cell's K, so each holds all of them
        inputs = [upload(a, dgrid.device) if dgrid.mesh is None
                  else Replicated(a, dgrid.mesh) for a in host]
        flags = dgrid.place(np.asarray(neumann_flag)[:p] != 0)
    with span(FACE_BUILD):
        table = dgrid.map_rows(
            lambda dev, geo, pair, inpofa: face_ops.face_table(
                geo, pair, inpofa, *(local(x, dev) for x in inputs)),
            dgrid.face_geo, dgrid.esuf_pair, dgrid.inpofa)
    return table, flags


def gls_gather(dgrid, face_table, neumann_flag, nodes, E, F, with_neumann,
               tau_guard="squared"):
    """Stencil gathers + the float64 geometric pieces for a chunk of nodes
    (counterpart of ninpol_tpu's _gls_gather_raw and the math of
    _gls_gather_fused).  Returns the solve kernel's keyword inputs and
    each node's cell count n_elem.

    ``tau_guard`` picks how tau = ||T2||^(-eta) is kept finite:
    "squared" clamps ||T2||^2 at 1e-30 (the fused TPU kernel's prologue);
    "norm" clamps ||T2|| at 1e-30 (ninpol_tpu's XLA prologue, which its
    exact and unfused routes use)."""
    B = nodes.shape[0]
    dev = nodes.device
    f64 = torch.float64
    KSetv = dgrid.esup2d[nodes, :E]
    n_elem = torch.clamp_max(dgrid.esup_cnt[nodes], E)
    cell_valid = ((torch.arange(E, device=dev)[None, :] < n_elem[:, None])
                  & (KSetv >= 0))
    KS = torch.where(cell_valid, KSetv, 0)
    Sv = dgrid.fsup2d[nodes, :F]
    n_face = torch.clamp_max(dgrid.fsup_cnt[nodes], F)
    face_valid = ((torch.arange(F, device=dev)[None, :] < n_face[:, None])
                  & (Sv >= 0))
    SF = torch.where(face_valid, Sv, 0).long()
    pair = dgrid.esuf_pair[SF]                                  # (B,F,2)
    ft = face_table[SF]                                         # (B,F,14)
    xv = dgrid.point_coords[nodes]                              # (B,3)
    cen = dgrid.centroids[KS.long()]                            # (B,E,3)

    k2 = pair[..., 1]
    interior = face_valid & (k2 >= 0)
    bnd = face_valid & (k2 < 0)
    im = interior.to(f64)[..., None]
    Nf, fc = ft[..., 0:3], ft[..., 3:6]
    nL1, nL2 = ft[..., 6:9], ft[..., 9:12]
    eta, nmean = ft[..., 12], ft[..., 13]
    T1 = xv[:, None, :] - fc
    T2 = torch.linalg.cross(Nf, T1)
    t2n2 = torch.sum(T2 * T2, dim=2)
    if tau_guard == "norm":
        base = torch.where(interior, torch.clamp_min(torch.sqrt(t2n2), 1e-30),
                           1.0)
        tau = base ** (-eta)
    elif tau_guard == "squared":
        base = torch.where(interior, torch.clamp_min(t2n2, 1e-30), 1.0)
        tau = base ** (-0.5 * eta)
    else:
        raise ValueError(f"tau_guard must be 'squared' or 'norm', got "
                         f"{tau_guard!r}")
    inp = dict(
        dk=(cen - xv[:, None, :]) * cell_valid.to(f64)[..., None],
        l1=nL1 * im, l2=nL2 * im, t1m=T1 * im,
        tt=tau[..., None] * T2 * im,
        lb=nL1 * bnd.to(f64)[..., None] if with_neumann else None,
        nm=nmean * bnd.to(f64) if with_neumann else None,
        pair=pair.contiguous(), ks=KS.contiguous(), cv=cell_valid,
        fv=face_valid, isneu=neumann_flag[nodes],
        valid=torch.ones(B, dtype=torch.bool, device=dev))
    return inp, n_elem


def gls_solve_unfused(dk, l1, l2, t1m, tt, lb, nm, pair, ks, cv, fv, isneu,
                      valid, *, sweeps=3, tiny=1e-12, shift=1.5e-5):
    """The GLS solve as ninpol_tpu's unfused route composes it
    (gls.py:602-658 and the epilogue's weight extraction, :712-733):
    ``gls_solve``'s inputs and outputs, from ``cholqr2_solve`` with the
    preconditioner built by the four kernels of ops/cholqr.py and the
    sweeps in float64 torch ops on the dense float64 A (where that route
    uses df32)."""
    return cholqr2_solve(KERNELS, dk, l1, l2, t1m, tt, lb, nm, pair, ks, cv,
                         fv, isneu, valid, sweeps=sweeps, tiny=tiny,
                         shift=shift)


def csne_system(dk, l1, l2, t1m, tt, lb, pair, ks, cv, fv, isneu, valid):
    """The dense float64 A (B, m, n) of ``gls_solve_csne`` and
    ``gls_solve_refined``, and the active-node mask."""
    S1, S2, Sb = incidence(pair, ks, cv, fv, isneu)
    active = node_active(pair, fv, valid)
    A = assemble(dk, l1, l2, t1m, tt, lb, S1, S2, Sb, cv, active)
    return A, active


def gls_solve_csne(dk, l1, l2, t1m, tt, lb, nm, pair, ks, cv, fv, isneu,
                   valid, *, pieces=qr.KERNELS):
    """The GLS solve of ninpol_tpu's ``solver="pallas"`` route
    (gls.py:659-705, weights as at :712-733), with ``gls_solve``'s inputs
    and outputs: R of the Householder QR of the dense float64 A with an
    identity row appended for each dead (all-zero) column, which keeps R's
    diagonal aligned without coupling that column to real rows (``qr_r``
    takes A and never builds those rows); y from the semi-normal
    equations R^T R y = e_n, one float64 correction
    y += SNE(e_n - A^T A y) (corrected semi-normal equations);
    rnorm = ||dy|| / ||y||, 1 where min|R_kk| / max|R_kk| < 1e-6.
    ``pieces`` are (qr_r, sne_solve): ``qr.KERNELS`` (the wrappers) or
    ``qr.PLAIN``.  The TPU's padding of the rows to a multiple of 32 is
    left out: zero rows change no R."""
    qr_r, sne_solve = pieces
    B, E, _ = dk.shape
    F = l1.shape[1]
    n = 3 * E + 1
    f64 = torch.float64
    A, active = csne_system(dk, l1, l2, t1m, tt, lb, pair, ks, cv, fv, isneu,
                            valid)
    R = qr_r(A)
    b = torch.zeros((B, n), dtype=f64, device=dk.device)
    b[:, n - 1] = 1.0
    y = sne_solve(R, b)
    dy = sne_solve(R, b - mul_G(A, y))
    y = y + dy
    rnorm = torch.linalg.vector_norm(dy, dim=1) / torch.clamp_min(
        torch.linalg.vector_norm(y, dim=1), 1e-300)
    rnorm = torch.where(qr.r_diag_quality(R) < 1e-6, 1.0, rnorm)
    return solve_outputs(A, y, rnorm, nm, active, E, F)


def gls_solve_refined(dk, l1, l2, t1m, tt, lb, nm, pair, ks, cv, fv, isneu,
                      valid, *, n_refine=2):
    """The GLS solve of ninpol_tpu's "refined" route (gls.py:706-710,
    weights as at :712-733), with ``gls_solve``'s inputs and outputs:
    ``ops.solve.solve_normal_refined`` on the dense float64 A, whose float32
    rounding is its preconditioner's input, with ``n_refine`` sweeps (not
    n_refine + 1, as the CholeskyQR2 routes run) through ``mul_G``."""
    B, E, _ = dk.shape
    F = l1.shape[1]
    n = 3 * E + 1
    A, active = csne_system(dk, l1, l2, t1m, tt, lb, pair, ks, cv, fv, isneu,
                            valid)
    b = torch.zeros((B, n), dtype=torch.float64, device=dk.device)
    b[:, n - 1] = 1.0
    y, rnorm = solve_normal_refined(A, b, lambda y: mul_G(A, y), n_refine)
    return solve_outputs(A, y, rnorm, nm, active, E, F)


def gls_epilogue(w, wn, rnorm, inp, n_elem, neumann_compat):
    """Mask the solve outputs (counterpart of ninpol_tpu gls.py:279-295):
    weights by active & cell-valid, the Neumann weight (the last cell
    weight under neumann_compat) by active & Neumann, rnorm by active."""
    active = node_active(inp["pair"], inp["fv"], inp["valid"])
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    w = torch.where(active[:, None] & inp["cv"], w, zero)
    if neumann_compat:
        last = torch.clamp_min(n_elem - 1, 0).long()[:, None]
        wn = torch.gather(w, 1, last)[:, 0]
    wn = torch.where(active & inp["isneu"], wn, zero)
    return w, wn, torch.where(active, rnorm, zero)


def exact_system(inp, n_elem):
    """The dense float64 least-squares problem of ``gls_exact``: A (B, m,
    n) with identity rows for the padding columns appended, and the
    right-hand sides (B, m, E + 1), the cell identity and the Neumann
    means.  The node's last solution row is [cell weights | Neumann
    weight]."""
    dk, lb, cv = inp["dk"], inp["lb"], inp["cv"]
    B, E, _ = dk.shape
    F = inp["l1"].shape[1]
    f64 = torch.float64
    dev = dk.device
    S1, S2, Sb = incidence(inp["pair"], inp["ks"], cv, inp["fv"],
                           inp["isneu"])
    active = node_active(inp["pair"], inp["fv"], inp["valid"])
    A = assemble(dk, inp["l1"], inp["l2"], inp["t1m"], inp["tt"], lb,
                 S1, S2, Sb, cv, active)
    # Identity rows for the padding columns keep the Householder diagonal
    # positionally aligned (a zero column contributes no reflector).
    pad_col = (torch.arange(3 * E, device=dev)[None, :]
               >= 3 * n_elem[:, None]).to(f64)
    reg = torch.cat([torch.diag_embed(pad_col),
                     torch.zeros((B, 3 * E, 1), dtype=f64, device=dev)],
                    dim=2)
    A = torch.cat([A, reg], dim=1)
    m = A.shape[1]
    af = active.to(f64)
    rhs = torch.zeros((B, m, E + 1), dtype=f64, device=dev)
    rhs[:, :E, :E] = (torch.eye(E, dtype=f64, device=dev)[None]
                      * cv.to(f64)[:, :, None] * af[:, None, None])
    if lb is not None:
        rhs[:, E + 3 * F:E + 4 * F, E] = (
            inp["nm"] * inp["isneu"].to(f64)[:, None] * af[:, None])
    return A, rhs


def gls_exact(inp, n_elem):
    """Float64 Householder least squares (the dgels-equivalent path of
    ninpol_tpu's _gls_bucket_impl(exact=True)): returns the cell weights
    and the true Neumann-column weight."""
    E = inp["dk"].shape[1]
    A, rhs = exact_system(inp, n_elem)
    last = householder_lastrow(torch.cat([A, rhs], dim=2), 3 * E + 1)
    return last[:, :E], last[:, E]


def class_chunk(E, F, chunk_nodes=32768):
    """Nodes per solve-kernel launch of an (E, F) class: ``chunk_nodes``,
    capped so that a chunk holds at most CHUNK_ELEMS system elements."""
    return max(1, min(chunk_nodes, CHUNK_ELEMS // ((E + 4 * F) * (3 * E + 1))))


def solve_class(dgrid, face_table, nflag, c, sel, chunk, route, exact, *,
                sweeps=3, rounds=2, n_refine=2, neumann_compat=True):
    """Solve the members ``sel`` of stencil class ``c`` on ``route``, or on
    the exact path: their nodes split over the grid's shards and chunked
    at ``chunk`` (``parallel.schedule``), each chunk gathered and solved on
    its shard's device.  Yields, per chunk, the slice [a, b) of the
    selected members and its masked (w, wn, rnorm) on the grid's primary
    device (``dgrid.device``)."""
    # only the fused kernel's prologue guards tau on ||T2||^2
    fused = route == "fused" and not exact
    nodes_all = c["nodes"][sel]
    for k, a, b in schedule(len(nodes_all), len(dgrid.shards), chunk):
        view = dgrid.on(k)
        nodes = upload(nodes_all[a:b], view.device)
        with span(GATHER_RANGE):
            inp, n_elem = gls_gather(
                view, local(face_table, view.device),
                local(nflag, view.device), nodes, c["E"], c["F"],
                c["with_neumann"], tau_guard="squared" if fused else "norm")
        with span(EXACT_RANGE if exact else SOLVE_RANGE):
            if exact:
                w, wn = gls_exact(inp, n_elem)
                rn = torch.zeros_like(wn)
            elif route == "csne":
                w, wn, rn = gls_solve_csne(**inp)
            elif route == "refined":
                w, wn, rn = gls_solve_refined(**inp, n_refine=n_refine)
            elif fused:
                # one round runs two more sweeps (ninpol_tpu gls.py:277)
                w, wn, rn = gls_solve(
                    **inp, rounds=rounds,
                    sweeps=sweeps + (2 if rounds == 1 else 0))
            else:
                w, wn, rn = gls_solve_unfused(**inp, sweeps=sweeps)
        with span(EPILOGUE_RANGE):
            out = gls_epilogue(w, wn, rn, inp, n_elem, neumann_compat)
        if view.device != dgrid.device:
            out = to_device(dgrid.device, *out)
        yield a, b, out


def sharded_gls(dgrid, mesh, shard_geometry=False):
    """A function running one GLS stencil class (a dict of
    ``DeviceGrid.buckets``) over ``mesh`` (counterpart of ninpol_tpu's
    ``parallel.sharding.sharded_gls``): the class's nodes split over the
    shards of ``dgrid``, which must already be placed on ``mesh`` with
    this ``shard_geometry`` (else ValueError).  The fused solve kernel
    runs with replicated geometry, the unfused route with partitioned
    geometry, as in ninpol_tpu; ``exact`` the float64 Householder path.

    ``run(bucket, perm, diff_mag, neumann_flag, neumann_val, n_refine=2,
    exact=False, neumann_compat=True, with_neumann=True)`` returns (w, wn,
    rnorm) in the bucket's node order on the mesh's primary device."""
    mesh = as_mesh(mesh)
    if dgrid.mesh != mesh or dgrid.shard_geometry != bool(shard_geometry):
        raise ValueError(
            f"the DeviceGrid is placed on {dgrid.mesh} with shard_geometry="
            f"{dgrid.shard_geometry}, not on {mesh} with shard_geometry="
            f"{bool(shard_geometry)}")
    route = "unfused" if shard_geometry else "fused"

    def run(bucket, perm, diff_mag, neumann_flag, neumann_val, n_refine=2,
            exact=False, neumann_compat=True, with_neumann=True):
        face_table, nflag = build_face_table(dgrid, perm, diff_mag,
                                             neumann_val, neumann_flag)
        c = dict(bucket, with_neumann=with_neumann)
        B, E = len(c["nodes"]), c["E"]
        f64, dev = torch.float64, dgrid.device
        w = torch.zeros((B, E), dtype=f64, device=dev)
        wn = torch.zeros(B, dtype=f64, device=dev)
        rn = torch.zeros(B, dtype=f64, device=dev)
        chunk = EXACT_CHUNK if exact else class_chunk(E, c["F"])
        for a, b, (wc, wnc, rnc) in solve_class(
                dgrid, face_table, nflag, c, slice(None), chunk, route,
                exact, sweeps=max(n_refine + 1, 2), n_refine=n_refine,
                neumann_compat=neumann_compat):
            w[a:b], wn[a:b], rn[a:b] = wc, wnc, rnc
        return w, wn, rn

    return run


class GLSInterpolation:
    """Driver matching the reference's prepare() contract
    (gls.pyx:38-72)."""

    def __init__(self, logging=False):
        self.logging = logging
        # refinement sweeps = n_refine + 1 (at least 2)
        self.n_refine = 2
        self.exact = False
        # True: the fused solve kernel (ops/gls_solve.py); False: the
        # unfused composition gls_solve_unfused (ops/cholqr.py kernels),
        # which Interpolator(shard_geometry=True) selects
        self.fused = True
        # "auto" and "cholqr": the CholeskyQR2 route ``fused`` picks;
        # "pallas": the CSNE cross-check route, gls_solve_csne (ops/qr.py
        # kernels); any other name: the "refined" route,
        # gls_solve_refined (ninpol_tpu gls.py:706-710)
        self.solver = "auto"
        # rounds of the fused kernel's CholeskyQR preconditioner
        # (ninpol_tpu gls.py:1108-1115): 1 drops round 2 and runs two more
        # sweeps; ninpol_tpu measured an exact-fallback storm with it on a
        # 1M-cell tet mesh.  The other routes ignore it, as ninpol_tpu's do.
        self.precond_rounds = 2
        self.neumann_compat = True
        # Nodes whose estimated relative solve error (last refinement
        # correction / solution norm) is not provably below this are
        # re-solved on the exact float64 Householder path.
        self.fallback_tol = 1e-11
        # nodes per solve-kernel launch (CHUNK_ELEMS may cap it lower)
        self.chunk_nodes = 32768
        # the per-(grid, variable) face table, keyed by the Interpolator's
        # data-version stamp (set on us as _data_token before each call)
        self._data_token = None
        self._face_cache_key = None
        self._face_cache = None
        # nodes sent to the exact path by the last prepare()
        self.last_n_bad = None
        # host delivery in float32 (ninpol_tpu gls.py:1597-1603; the
        # Interpolator sets it before each call)
        self.delivery_f32 = False

    def _face_table(self, dgrid, cells_data, points_data,
                    variable_to_index, variable, neumann_flag):
        if self._data_token is not None:
            ckey = ("v", self._data_token, variable)
        else:   # direct prepare() calls outside an Interpolator
            ckey = (id(dgrid.grid), id(cells_data), id(points_data),
                    variable)
        if self._face_cache_key != ckey:
            # the stale table goes before the new one is built beside it
            self._face_cache = self._face_cache_key = None
            perm = cells_data[variable_to_index["cells"]["permeability"]]
            diff_mag = cells_data[variable_to_index["cells"]["diff_mag"]]
            nval = points_data[
                variable_to_index["points"]["neumann_" + variable]]
            self._face_cache = build_face_table(dgrid, perm, diff_mag, nval,
                                                neumann_flag)
            self._face_cache_key = ckey
        return self._face_cache

    def plan(self, dgrid, cells_data, points_data, variable_to_index,
             variable, target_points):
        """The work of one prepare(): the stencil classes of the target
        nodes that get a solve (each with its solve-kernel chunk size),
        the variable's face table and the device Neumann flags (the
        phase spans ``face_table`` and ``class_plan``)."""
        grid = dgrid.grid
        nf_idx = variable_to_index["points"]["neumann_flag_" + variable]
        neumann_flag = points_data[nf_idx].astype(np.int32)
        with span(FACE_TABLE):
            face_table, nflag_dev = self._face_table(
                dgrid, cells_data, points_data, variable_to_index, variable,
                neumann_flag)
        with span(CLASS_PLAN):
            tp = np.asarray(target_points)
            # skip Dirichlet boundary nodes (gls.pyx:165-166) and nodes
            # that assemble no system (their rows stay zero)
            active = (~(grid.boundary_points[tp].astype(bool)
                        & (neumann_flag[tp] == 0))
                      & dgrid.assembling(tp))

            # Interior nodes skip the Neumann row block (F fewer rows), so
            # Neumann-boundary nodes form their own classes.
            is_neu_t = neumann_flag[tp] != 0
            classes = []
            for mask, wneu in ((active & ~is_neu_t, False),
                               (active & is_neu_t, True)):
                for c in dgrid.buckets(tp, mask):
                    c["with_neumann"] = wneu
                    c["chunk"] = class_chunk(c["E"], c["F"],
                                             self.chunk_nodes)
                    classes.append(c)
        return classes, face_table, nflag_dev

    def route(self):
        """The solve route of the settings, as ninpol_tpu dispatches its
        solver names (gls.py:602-710): "fused" or "unfused" (the
        CholeskyQR2 routes), "csne" or "refined"."""
        if self.solver in ("auto", "cholqr"):
            return "fused" if self.fused else "unfused"
        return "csne" if self.solver == "pallas" else "refined"

    def prepare(self, dgrid, cells_data, points_data, faces_data,
                variable_to_index, variable, target_points,
                weights, neumann_ws, device_out=False):
        # With the recorder on (NINPOL_TPU_PHASES=1, ninpol_tpu's hook;
        # utils/tracing.py) one line to stderr: the host wall time from the
        # start of the prepare span to the end of each phase span.  No
        # sync is added: the steps overlap device work, so the times are
        # the dispatch side's, not the device's.  The names are
        # ninpol_tpu's for the steps the port has, in the port's order:
        # its rows are scattered into one device array chunk by chunk (no
        # "consolidate"), and the host copy follows the exact fallback
        # (ninpol_tpu writes the host rows first and patches the
        # fallback's).
        with span(PREPARE) as top:
            out = self._prepare(dgrid, cells_data, points_data,
                                variable_to_index, variable, target_points,
                                weights, neumann_ws, device_out)
        phases = children(top)
        if phases is not None:
            print("# gls phases: " + " ".join(
                f"{PHASE_MARKS[s.name].format(n_bad=self.last_n_bad)}="
                f"{(s.end_ns - top.start_ns) / 1e9:.3f}s" for s in phases
                if s.name in PHASE_MARKS), file=sys.stderr)
        return out

    def _prepare(self, dgrid, cells_data, points_data, variable_to_index,
                 variable, target_points, weights, neumann_ws, device_out):
        route = self.route()
        sweeps = max(self.n_refine + 1, 2)
        classes, face_table, nflag_dev = self.plan(
            dgrid, cells_data, points_data, variable_to_index, variable,
            target_points)
        dev = dgrid.device
        tp = np.asarray(target_points)
        n_target = len(tp)
        ncols = weights.shape[1]
        wdev = torch.zeros((n_target, ncols + 1), dtype=torch.float64,
                           device=dev)

        def solve(c, sel, chunk, exact):
            """Solve the class members ``sel``; scatter their rows into
            wdev; return [(positions, rnorm)] per chunk."""
            pos_all = c["pos"][sel]
            out = []
            for a, b, (w, wn, rn) in solve_class(
                    dgrid, face_table, nflag_dev, c, sel, chunk, route,
                    exact, sweeps=sweeps, rounds=self.precond_rounds,
                    n_refine=self.n_refine,
                    neumann_compat=self.neumann_compat):
                pos = upload(pos_all[a:b], dev)
                k = min(c["E"], ncols)
                wdev[pos, :k] = w[:, :k]
                wdev[pos, ncols] = wn
                out.append((pos, rn))
            return out

        if self.exact:
            bad = [np.ones(len(c["pos"]), dtype=bool) for c in classes]
            n_bad = int(sum(b.sum() for b in bad))
        else:
            rndev = torch.zeros(n_target, dtype=torch.float64, device=dev)
            with span(DISPATCH):
                for c in classes:
                    for pos, rn in solve(c, slice(None), c["chunk"],
                                         exact=False):
                        rndev[pos] = rn
            bad, n_bad = None, 0
            if self.fallback_tol is not None:
                with span(N_BAD_SYNC):
                    # NaN-safe: anything not provably converged falls back
                    notconv = ~(rndev <= self.fallback_tol)
                    n_bad = int(to_host(notconv.sum()))
        if n_bad:
            with span(EXACT_FALLBACK):
                if bad is None:
                    bad_all = to_host(notconv).numpy()
                    bad = [bad_all[c["pos"]] for c in classes]
                for c, sel in zip(classes, bad):
                    if sel.any():
                        solve(c, sel, EXACT_CHUNK, exact=True)
        count("n_bad", n_bad)
        self.last_n_bad = n_bad

        if device_out:
            # (n_target, ncols + 1) float64 [weights | neumann_w] on the
            # device, for on-device consumers
            return wdev
        with span(HOST_WRITE):
            # cast on the device: half the bytes to the host
            host = to_host(wdev.float() if self.delivery_f32
                           else wdev).numpy()
            weights[:] = host[:, :ncols]
            neumann_ws[:] = host[:, ncols]
        return weights, neumann_ws
