"""On-card smoke check of the PyTorch port (ninpol_tpu_torch) on one GPU.

Drives the port's GLS main path — the path bench.py times for ninpol_tpu:
GLS weights with Neumann nodes, on the 1,886,592-cell tetrahedral mesh,
through the public Interpolator API — its shard_geometry=True route
(ninpol_tpu's unfused CholeskyQR2 composition) and its solver="pallas"
route (Householder R and corrected semi-normal equations), and checks
all three:

  1. prints the card (nvidia-smi name, power limit); requires CUDA;
  2. builds the three kernel libraries with nvcc, in parallel:
     csrc/gls_solve.cu (the fused solve), csrc/cholqr.cu (gram,
     chol_linv, round2_gram, prec_apply) and csrc/qr.cu (qr_r,
     sne_solve);
  3. builds bench.py's problem with the port's own meshgen: tetra_mesh(68),
     an ALH-style full-tensor K, u = x^2 + y^2 + z^2, a seeded (rng 0)
     Dirichlet/Neumann boundary split; once for the CholeskyQR2 routes
     (the solver="pallas" route runs on the fused route's problem);
  4. the solve kernel vs its plain PyTorch version on one chunk of every
     (E, F, with_neumann) class of the plan: w and wn agree to <= 1e-10
     scaled on the nodes both call converged, and the rnorm > 1e-11 sets
     agree; prints both times, the kernel's dynamic shared memory and
     blocks per SM, and the time of torch.linalg.lstsq on the largest
     class's dense float64 system;
     4b. one chunk padded to (E, F) = (64, 96), too wide for shared
     memory, so the kernel runs from its device workspace: same weights;
     4c. each cholqr kernel vs its plain version on one chunk of every
     class of the unfused route, on the inputs that route gives it: the
     products to <= 1e-5 scaled by the per-node max of the same product
     of the operands' magnitudes (|A|^T |A|, ..., |Lc|^T |Lc| |v|),
     and to <= 1e-5 of the per-node max of the result itself (prec_apply
     on a seeded random vector, as its route input cancels); the inverse
     factors by backward error
     max|X W X^T - I| (<= 10x the plain version's) with the same flagged
     pivots; prints kernel, plain and one library call's times (CUDA
     events), and each kernel's registers, local (spill) bytes, shared
     memory and blocks per SM per class; round2_gram's two bodies
     (registers, shared memory) each held to the same bound and timed,
     and the one its class takes;
     4d. qr_r and sne_solve vs their plain versions on one chunk of every
     class of the solver="pallas" route, on the inputs that route gives
     them: R of Ar = [A; diag(dead)] (qr_r takes A) by backward error
     max|R^T R - Ar^T Ar| / max|Ar^T Ar| per node (<= 10x the plain
     version's) with the same r_diag_quality flags, y on e_n, on the
     route's residual and on a seeded random b by residual
     ||R^T R y - b|| / (||R||_F^2 ||y||) (<= 10x the plain version's),
     and the whole gls_solve_csne through the kernels vs through the
     plain versions (<= 1e-10 scaled, the same rnorm > 1e-11 set);
     prints kernel, plain and library times, the time of each of the
     two bodies of qr_r (register tile, shared memory) and of sne_solve
     (a warp a node on the staged triangle, R from device memory; each
     held to the same residual bound), the body each class takes, and
     each body's registers, local bytes, shared memory and blocks per SM;
     4e. one chunk of the unfused route and one of the solver="pallas"
     route padded to (E, F) = (64, 96), where chol_linv, round2_gram and
     qr_r run from device workspaces: the unpadded weights (<= 1e-10
     scaled), the same rnorm > 1e-11 set;
  5. the main path: a warm-up prepare_interpolator, 3 timed device_out
     runs (torch.cuda.synchronize), interpolate() -> CSR; prints seconds,
     Mnodes/s, n_bad (which must be 0) and the kernel launch count, which
     must equal one launch per chunk per run (so every class went through
     the kernel), with no plain-version call; then one more run under
     torch.profiler (device busy share, top kernels);
     5b. the same for the shard_geometry=True route: per chunk per run
     exactly 1 gram, 2 chol_linv, 1 round2_gram and 4 prec_apply launches,
     no plain-version call and no solve-kernel launch; device-complete
     seconds beside the fused route's; a profiled run;
     5c. the same for solver="pallas": per chunk per run exactly 1 qr_r
     and 2 sne_solve launches and no other kernel's, no plain-version
     call; a profiled run;
  6. the delivered weights of the three routes against the scipy dgels
     oracle on 256 sampled nodes (128 interior, 128 Neumann; cond < 1e7):
     max scaled error <= 1e-10, interior rows sum to 1; and the other
     routes' weights against the fused route's, <= 1e-10 scaled.

Any failing phase raises (non-zero exit).  The last three lines are the
card, the kernels JSON line and {"ok": true, "device": {...}}.

Run: python3 chip_smoke.py            (options: --n N, the mesh size)
"""
import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL_KERNEL = 1e-10     # kernel vs plain version, scaled by max |w|
TOL_ORACLE = 1e-10     # delivered weights vs dgels, scaled (bench.py)
RNORM_TOL = 1e-11      # the exact-fallback threshold (fallback_tol)
# float32 cholqr products vs their plain versions, scaled per node by the
# max of the operands' magnitude product: ~100 eps32 of room for another
# summation order
TOL_F32 = 1e-5
CHOL_BACKWARD_RATIO = 10.0
# qr_r's backward error and sne_solve's residual: at most this times the
# plain version's
QR_RATIO = 10.0
# nodes any route may send to the exact fallback: every node of this
# problem converges in the fast solve on the H100 (tetra_mesh(68))
MAX_BAD = 0
# H100 SXM peaks (NVIDIA data sheet, 700 W): FP32 off the tensor cores,
# FP64 on them (DMMA; 34e12 off them), and HBM3 bandwidth; bound_ms takes
# the larger of the two times
PEAK_FP32 = 67e12
PEAK_FP64 = 67e12
PEAK_BYTES = 3.35e12
SOLVE_KERNELS = ("gram_f32", "chol_linv_f32", "round2_gram_f32",
                 "prec_apply_f32")
# kernel launches per solve chunk of each route
PER_CHUNK = {"fused": {"gls_solve": 1},
             "shard_geometry": {"gram_f32": 1, "chol_linv_f32": 2,
                                "round2_gram_f32": 1, "prec_apply_f32": 4},
             "pallas": {"qr_r": 1, "sne_solve": 2}}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(flops, nbytes, peak=PEAK_FP32):
    """The least time (ms) the card could take: the larger of the
    operations over their type's peak (FP32 unless stated) and the bytes
    over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes")


def build_problem(n, shard_geometry=False):
    """bench.py:33-101 with the port's meshgen and Interpolator: a
    ~6n^3-cell tet mesh, ALH-style varying full-tensor K, u = x^2+y^2+z^2,
    seeded Dirichlet/Neumann split, Neumann flux -(K grad u).n at
    boundary-face centers averaged onto the points."""
    from ninpol_tpu_torch import Interpolator
    from ninpol_tpu_torch.utils import meshgen

    mesh = meshgen.tetra_mesh(n)
    pts = mesh.points
    cells = mesh.cells[0].data
    cents = pts[cells].mean(axis=1)
    x, y, z = cents[:, 0], cents[:, 1], cents[:, 2]
    K = np.zeros((len(cells), 3, 3))
    K[:, 0, 0] = y * y + z * z + 1
    K[:, 0, 1] = K[:, 1, 0] = -x * y
    K[:, 0, 2] = K[:, 2, 0] = -x * z
    K[:, 1, 1] = x * x + z * z + 1
    K[:, 1, 2] = K[:, 2, 1] = -y * z
    K[:, 2, 2] = x * x + y * y + 1
    sol = x ** 2 + y ** 2 + z ** 2

    interp = Interpolator(shard_geometry=shard_geometry)
    mesh.cell_data = {"permeability": [K.reshape(-1, 9)], "u": [sol]}
    mesh.point_data = {}
    t0 = time.perf_counter()
    interp.load_mesh(mesh_obj=mesh)
    build_s = time.perf_counter() - t0
    grid = interp.grid

    rng = np.random.default_rng(0)
    boundary = np.nonzero(grid.boundary_faces)[0]
    ridx = rng.choice(len(boundary), len(boundary) // 2, replace=False)
    neumann_faces = np.setdiff1d(boundary, boundary[ridx])
    pv = np.zeros(grid.n_points)
    dpts = grid.inpofa[boundary[ridx]].ravel()
    np.add.at(pv, dpts[dpts != -1], 1)
    npts = grid.inpofa[neumann_faces].ravel()
    np.add.at(pv, npts[npts != -1], -1)
    bpts = np.nonzero(grid.boundary_points)[0]
    neumann_points = bpts[pv[bpts] < 0]

    owners = grid.esuf[grid.esuf_ptr[boundary]]
    fc = grid.faces_centers[boundary]
    flux = -np.einsum("fij,fj->fi", K[owners], 2 * fc)
    nval_faces = np.zeros(grid.n_faces)
    nval_faces[boundary] = np.einsum(
        "fi,fi->f", flux, grid.normal_faces[boundary])
    counts = np.diff(grid.fsup_ptr)
    owner_pt = np.repeat(np.arange(grid.n_points), counts)
    sums = np.bincount(owner_pt, weights=nval_faces[grid.fsup],
                       minlength=grid.n_points)
    neumann = np.zeros(grid.n_points)
    neumann[neumann_points] = (sums / np.maximum(counts, 1))[neumann_points]
    nflag = np.zeros(grid.n_points)
    nflag[neumann_points] = 1
    interp.load_data({"neumann_u": neumann, "neumann_flag_u": nflag,
                      "dirichlet_flag_u": 1 - nflag}, "points")
    return interp, build_s


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, after one warm-up run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_vs_plain(interp, tp):
    """Phase 4: one chunk of every class through the kernel and through
    the plain version, on the card."""
    from ninpol_tpu_torch._methods.gls import gls_gather
    from ninpol_tpu_torch.ops import gls_solve as gs

    dgrid = interp.device_grid
    classes, face_table, nflag = interp.gls.plan(
        dgrid, interp.cells_data, interp.points_data,
        interp.variable_to_index, "u", tp)
    rows = []
    for c in classes:
        B = min(c["chunk"], len(c["nodes"]))
        nodes = torch.as_tensor(c["nodes"][:B], device=dgrid.device)
        inp, n_elem = gls_gather(dgrid, face_table, nflag, nodes, c["E"],
                                 c["F"], c["with_neumann"])
        wk, wnk, rk = gs.gls_solve(**inp)
        wp, wnp, rp = gs.gls_solve_reference(**inp)
        torch.cuda.synchronize()
        conv = (rk <= RNORM_TOL) & (rp <= RNORM_TOL)
        scale = max(float(wp.abs().max()), 1.0)
        err = max(float((wk - wp)[conv].abs().max()),
                  float((wnk - wnp)[conv].abs().max())) if conv.any() else 0.0
        same_set = bool(torch.equal(rk > RNORM_TOL, rp > RNORM_TOL))
        ms = cuda_ms(lambda: gs.gls_solve(**inp), 3)
        plain_ms = cuda_ms(lambda: gs.gls_solve_reference(**inp), 2)
        # three m n^2/2-FMA products (Gram1, Q, Gram2), two clamped
        # Cholesky factorizations and two triangular inverses (n^3/3 FLOP
        # each); the float64 sweeps are O(m n) per node and left out
        E, F = c["E"], c["F"]
        m, n = E + (4 if c["with_neumann"] else 3) * F, 3 * E + 1
        nbytes = (sum(x.nbytes for x in inp.values() if x is not None)
                  + B * (E + 2) * 8)
        bound_ms, bound_by = bound(B * (3 * m * n * n + 4 * n ** 3 / 3),
                                   nbytes)
        smem, blocks = gs.occupancy(E, F, c["with_neumann"])
        row = {"E": E, "F": F, "with_neumann": c["with_neumann"],
               "nodes_in_class": len(c["nodes"]), "chunk": B,
               "smem_bytes": smem, "blocks_per_sm": blocks,
               "max_abs_err": err, "max_scaled_err": err / scale,
               "n_unconverged_kernel": int((rk > RNORM_TOL).sum()),
               "n_unconverged_plain": int((rp > RNORM_TOL).sum()),
               "same_fallback_set": same_set, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None}
        if c is max(classes, key=lambda c: len(c["nodes"])):
            row["library_ms"] = lstsq_ms(inp, n_elem)
        print("# class " + json.dumps(row), flush=True)
        check(err / scale <= TOL_KERNEL,
              f"kernel vs plain: scaled error {err / scale:.3e} > "
              f"{TOL_KERNEL} in class {row}")
        check(same_set, f"kernel and plain rnorm > {RNORM_TOL} sets differ "
                        f"in class {row}")
        rows.append(row)
    return classes, rows


def lstsq_ms(inp, n_elem):
    """One torch.linalg.lstsq(driver="gels") on the chunk's dense float64
    exact system (gls_exact's: identity rows for the padding columns, the
    cell identity and Neumann means as right-hand sides): the nearest
    single library call to the solve kernel, not the same function (no
    preconditioner, no refinement, a QR instead)."""
    from ninpol_tpu_torch._methods.gls import exact_system

    A, rhs = exact_system(inp, n_elem)
    return cuda_ms(lambda: torch.linalg.lstsq(A, rhs, driver="gels"), 1)


def pad_class(inp, E2, F2):
    """The same nodes in a wider class: cells and faces past the real ones
    are invalid, so the solution is unchanged."""
    def pad(x, dim1, fill=0):
        shape = list(x.shape)
        shape[1] = dim1 - shape[1]
        return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                        device=x.device)], dim=1)
    out = dict(inp)
    for k in ("dk", "ks", "cv"):
        out[k] = pad(inp[k], E2)
    for k in ("l1", "l2", "t1m", "tt", "lb", "nm", "pair", "fv"):
        if inp[k] is not None:
            out[k] = pad(inp[k], F2)
    return out


def workspace_path(interp, tp, classes):
    """Phase 4b: a class too wide for shared memory runs A, G and L from
    the per-node device workspace; padding a real chunk to (E, F) =
    (64, 96) must not change its weights."""
    from ninpol_tpu_torch._methods.gls import gls_gather
    from ninpol_tpu_torch.ops import gls_solve as gs

    dgrid = interp.device_grid
    _, face_table, nflag = interp.gls.plan(
        dgrid, interp.cells_data, interp.points_data,
        interp.variable_to_index, "u", tp)
    c = classes[-1]
    nodes = torch.as_tensor(c["nodes"][:4096], device=dgrid.device)
    inp, _ = gls_gather(dgrid, face_table, nflag, nodes, c["E"], c["F"],
                        c["with_neumann"])
    wide = pad_class(inp, 64, 96)
    ws = gs.library.get().gls_solve_workspace_floats(
        64, 96, int(c["with_neumann"]))
    check(ws > 0, "(64, 96) unexpectedly fits in shared memory")
    w, wn, rn = gs.gls_solve(**inp)
    w2, wn2, rn2 = gs.gls_solve(**wide)
    torch.cuda.synchronize()
    scale = max(float(w.abs().max()), 1.0)
    err = max(float((w2[:, :c["E"]] - w).abs().max()),
              float((wn2 - wn).abs().max()), float(w2[:, c["E"]:].abs().max()))
    stats = {"E": c["E"], "F": c["F"], "with_neumann": c["with_neumann"],
             "nodes": len(nodes), "workspace_floats_per_node": ws,
             "max_scaled_err": err / scale}
    print("# workspace path " + json.dumps(stats), flush=True)
    check(err / scale <= TOL_KERNEL, f"workspace path differs: {stats}")
    check(torch.equal(rn > RNORM_TOL, rn2 > RNORM_TOL),
          "workspace path changes the fallback set")


def scaled_err(x, ref, scale):
    """max over nodes of max|x - ref| / max(scale), per node."""
    d = (x - ref).abs().flatten(1).amax(dim=1)
    s = scale.abs().flatten(1).amax(dim=1).clamp_min(1e-30)
    return float((d / s).max())


def flagged(X):
    """Nodes whose inverse factor shows a clamped pivot, or overflowed."""
    from ninpol_tpu_torch.ops.cholqr import SICK_DINV

    return ~(X.diagonal(dim1=1, dim2=2).abs().amax(dim=1) <= SICK_DINV)


def chol_backward_error(X, G, P, ok):
    """max over the nodes ``ok`` of max|X W X^T - I| in float64, with
    W = P^-1 G P^-T (W = G without P): how far X = L^-1 P is from an
    exact inverse factor of G = L L^T."""
    B, n, _ = G.shape
    eye = torch.eye(n, dtype=torch.float64, device=G.device)
    X, W = X.double(), G.double()
    if P is not None:
        Pi = torch.linalg.solve_triangular(P.double(), eye.expand(B, n, n),
                                           upper=False)
        W = Pi @ W @ Pi.transpose(1, 2)
    R = (X @ W @ X.transpose(1, 2) - eye).abs().flatten(1).amax(dim=1)
    return float(R[ok].max())


def cholqr_vs_plain(interp, tp):
    """Phase 4c: each cholqr kernel against its plain version on one chunk
    of every class of the unfused route, on the inputs that route gives
    it (the kernels' own stages feed the next kernel, as in a run)."""
    from ninpol_tpu_torch._methods.gls import gls_gather
    from ninpol_tpu_torch.ops import cholqr as cq
    from ninpol_tpu_torch.ops.gls_solve import (assemble, incidence,
                                                node_active)

    dgrid = interp.device_grid
    classes, face_table, nflag = interp.gls.plan(
        dgrid, interp.cells_data, interp.points_data,
        interp.variable_to_index, "u", tp)
    rows = {k: [] for k in SOLVE_KERNELS}
    f64 = torch.float64
    for c in classes:
        B = min(c["chunk"], len(c["nodes"]))
        nodes = torch.as_tensor(c["nodes"][:B], device=dgrid.device)
        inp, _ = gls_gather(dgrid, face_table, nflag, nodes, c["E"], c["F"],
                            c["with_neumann"], tau_guard="norm")
        S1, S2, Sb = incidence(inp["pair"], inp["ks"], inp["cv"], inp["fv"],
                               inp["isneu"])
        A = assemble(inp["dk"], inp["l1"], inp["l2"], inp["t1m"], inp["tt"],
                     inp["lb"], S1, S2, Sb, inp["cv"],
                     node_active(inp["pair"], inp["fv"], inp["valid"]))
        pc = cq.cholqr_factors(A, cq.KERNELS)
        As, G1, Li1, G2, Lc = (pc[k] for k in ("As", "G1", "Li1", "G2", "Lc"))
        _, m, n = As.shape
        # prec_apply's input in the first refinement sweep: the scaled
        # residual of y = M e_n (M e_n itself reads one column of Lc)
        D = pc["D"].to(f64)
        b = torch.zeros((B, n), dtype=f64, device=A.device)
        b[:, n - 1] = 1.0
        y = cq.prec_apply_f32(Lc, (b * D).float()).to(f64) * D
        r = b - torch.einsum("bmn,bm->bn", A,
                             torch.einsum("bmn,bn->bm", A, y))
        v = (r * D).float()
        del A, inp, S1, S2, Sb, y, r
        head = {"E": c["E"], "F": c["F"], "with_neumann": c["with_neumann"],
                "chunk": B, "m": m, "n": n}
        out_bytes = B * n * n * 4

        # prec_apply also on a seeded random vector, whose image does not
        # cancel: held to the per-node max of the result itself
        v_rand = torch.randn((B, n), device=Lc.device, generator=torch.
                             Generator(device=Lc.device).manual_seed(0))
        got = cq.prec_apply_f32(Lc, v_rand)
        ref = cq.prec_apply_f32_reference(Lc, v_rand)
        prec_random = {"random_v_err_over_result": scaled_err(got, ref, ref),
                       "random_v_max_abs_err": float((got - ref).abs().max())}
        del got, ref, v_rand

        def timed(row, kernel, plain, library, flops, nbytes):
            row["ms"] = cuda_ms(kernel, 5)
            row["plain_ms"] = cuda_ms(plain, 2)
            row["library_ms"] = cuda_ms(library, 5)
            row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
            return row

        # Each product with, as its error scale, the same product of the
        # operands' magnitudes (|X|^T |Y|): float32 rounding bounds the gap
        # between two summation orders by a multiple of eps32 times that,
        # while the result itself can be far smaller (prec_apply's
        # residual input cancels: |Lc^T Lc v| << |Lc|^T |Lc| |v|; its
        # random input above is held to the result).  FLOPs count the
        # triangles the route's operands have: Li1 and Lc are lower
        # triangular, a Gram matrix is symmetric.
        aAs, aLi1, aLc = As.abs(), Li1.abs(), Lc.abs()
        products = {
            "gram_f32": (lambda: cq.gram_f32(As),
                         lambda: cq.gram_f32_reference(As),
                         lambda: torch.bmm(As.transpose(1, 2), As),
                         lambda: torch.bmm(aAs.transpose(1, 2), aAs),
                         B * m * n * (n + 1), As.nbytes + out_bytes),
            "round2_gram_f32": (
                lambda: cq.round2_gram_f32(As, Li1),
                lambda: cq.round2_gram_f32_reference(As, Li1),
                lambda: (lambda Q: torch.bmm(Q.transpose(1, 2), Q))(
                    torch.bmm(As, Li1.transpose(1, 2))),
                lambda: (lambda Q: torch.bmm(Q.transpose(1, 2), Q))(
                    torch.bmm(aAs, aLi1.transpose(1, 2))),
                2 * B * m * n * (n + 1),
                As.nbytes + Li1.nbytes + out_bytes),
            "prec_apply_f32": (
                lambda: cq.prec_apply_f32(Lc, v),
                lambda: cq.prec_apply_f32_reference(Lc, v),
                lambda: torch.bmm(Lc.transpose(1, 2),
                                  torch.bmm(Lc, v[:, :, None])),
                lambda: torch.bmm(aLc.transpose(1, 2),
                                  torch.bmm(aLc, v.abs()[:, :, None])),
                2 * B * n * (n + 1), Lc.nbytes + 2 * v.nbytes)}
        occ = {k: cq.occupancy(k, n) for k in SOLVE_KERNELS}
        for name, (kernel, plain, library, magnitude, flops,
                   nbytes) in products.items():
            got, ref = kernel(), plain()
            err = scaled_err(got, ref, magnitude().reshape(ref.shape))
            abs_err = float((got - ref).abs().max())
            # the error held to the per-node max of a result: the Gram
            # products' own, prec_apply's on the random vector
            extra = prec_random if name == "prec_apply_f32" else {}
            row = timed(dict(head, max_err_over_magnitude=err,
                             max_err_over_result=scaled_err(got, ref, ref),
                             max_abs_err=max(abs_err, extra.get(
                                 "random_v_max_abs_err", 0.0)),
                             occupancy=occ[name], **extra),
                        kernel, plain, library, flops, nbytes)
            del got, ref
            if name == "round2_gram_f32":
                round2_bodies(row, As, Li1, magnitude, n)
            print(f"# {name} " + json.dumps(row), flush=True)
            check(err <= TOL_F32, f"{name} kernel vs plain: error "
                                  f"{err:.3e} of the magnitude product > "
                                  f"{TOL_F32} in {row}")
            result_err = extra.get("random_v_err_over_result",
                                   row["max_err_over_result"])
            check(result_err <= TOL_F32,
                  f"{name} kernel vs plain: error {result_err:.3e} of the "
                  f"result > {TOL_F32} in {row}")
            rows[name].append(row)
        del aAs, aLi1, aLc

        # chol_linv: the route's two calls, G1 and (G2, mul_right=Li1)
        eye = torch.eye(n, dtype=torch.float32, device=G1.device)
        for G, P in ((G1, None), (G2, Li1)):
            Xk = cq.chol_linv_f32(G, mul_right=P)
            Xp = cq.chol_linv_f32_reference(G, mul_right=P)
            fk, fp = flagged(Xk), flagged(Xp)
            ok = ~fk
            bk = chol_backward_error(Xk, G, P, ok) if ok.any() else 0.0
            bp = chol_backward_error(Xp, G, P, ok) if ok.any() else 0.0
            row = dict(head, mul_right=P is not None,
                       occupancy=occ["chol_linv_f32"],
                       n_flagged=int(fk.sum()),
                       backward_error=bk, plain_backward_error=bp,
                       max_abs_err=float((Xk - Xp)[ok].abs().max())
                       if ok.any() else 0.0)
            rhs = eye.expand(B, n, n) if P is None else P
            row = timed(
                row, lambda: cq.chol_linv_f32(G, mul_right=P),
                lambda: cq.chol_linv_f32_reference(G, mul_right=P),
                lambda: torch.linalg.solve_triangular(
                    torch.linalg.cholesky_ex(G).L, rhs, upper=False),
                # Cholesky n^3/3, then n^3/3 for the triangular rows of
                # L^-1 (or of L^-1 Li1, triangular too)
                B * 2 * n ** 3 / 3,
                G.nbytes + (0 if P is None else P.nbytes) + out_bytes)
            print("# chol_linv_f32 " + json.dumps(row), flush=True)
            check(torch.equal(fk, fp), f"chol_linv kernel and plain version "
                                       f"flag different pivots: {row}")
            check(bk <= CHOL_BACKWARD_RATIO * bp,
                  f"chol_linv backward error {bk:.3e} > "
                  f"{CHOL_BACKWARD_RATIO} x plain {bp:.3e}: {row}")
            rows["chol_linv_f32"].append(row)
        del pc, As, G1, Li1, G2, Lc, v, prec_random
    return classes, rows


def round2_bodies(row, As, Li1, magnitude, n):
    """Phase 4c for round2_gram_f32: the body its class takes, and each
    body's error (held to TOL_F32 of the magnitude product, as the
    default), time and launch on an SM."""
    from ninpol_tpu_torch.ops import cholqr as cq

    row["path"] = cq.library.get().round2_gram_f32_path(n)
    mag = magnitude()
    ref = cq.round2_gram_f32_reference(As, Li1)
    for p, label in ((2, "register"), (1, "shared")):
        if p == 2 and row["path"] != 2:    # no register body at this width
            continue
        err = scaled_err(cq.round2_gram_f32(As, Li1, path=p), ref,
                         mag.reshape(ref.shape))
        row[f"{label}_err_over_magnitude"] = err
        row[f"{label}_ms"] = cuda_ms(lambda: cq.round2_gram_f32(As, Li1,
                                                                path=p), 5)
        row[f"{label}_occupancy"] = cq.occupancy("round2_gram_f32", n, p)
        check(err <= TOL_F32, f"round2_gram_f32 {label} body: error "
                              f"{err:.3e} of the magnitude product > "
                              f"{TOL_F32}: {row}")


def qr_work(Ar):
    """FLOPs and bytes qr_r needs on Ar (B, m, n): per node, the
    Householder QR of its rows that are not zero (the route's real rows,
    one row per dead column), 2 p q^2 - 2/3 q^3 FLOP with q = min and
    p = max of that row count and n; those rows read, R's triangle
    written."""
    n = Ar.shape[2]
    rows = (Ar != 0).any(dim=2).sum(dim=1).double()
    p, q = rows.clamp_min(n), rows.clamp_max(n)
    flops = float((2 * p * q * q - 2 * q ** 3 / 3).sum())
    return flops, (float(rows.sum()) * n + len(rows) * n * (n + 1) / 2) * 8


def csne_vs_plain(interp, tp):
    """Phase 4d: qr_r and sne_solve against their plain versions on one
    chunk of every class of the solver="pallas" route, on the inputs that
    route gives them, and the route's whole solve through the kernels
    against the same function through the plain versions."""
    from ninpol_tpu_torch._methods.gls import (csne_system, gls_gather,
                                               gls_solve_csne)
    from ninpol_tpu_torch.ops import qr
    from ninpol_tpu_torch.ops.gls_solve import mul_G

    dgrid = interp.device_grid
    classes, face_table, nflag = interp.gls.plan(
        dgrid, interp.cells_data, interp.points_data,
        interp.variable_to_index, "u", tp)
    rows = {"qr_r": [], "sne_solve": []}
    f64 = torch.float64
    for c in classes:
        B = min(c["chunk"], len(c["nodes"]))
        nodes = torch.as_tensor(c["nodes"][:B], device=dgrid.device)
        inp, _ = gls_gather(dgrid, face_table, nflag, nodes, c["E"], c["F"],
                            c["with_neumann"], tau_guard="norm")
        head = {"E": c["E"], "F": c["F"], "with_neumann": c["with_neumann"],
                "chunk": B}

        # the whole solve, through the kernels and through the plain versions
        wk, wnk, rk = gls_solve_csne(**inp)
        wp, wnp, rp = gls_solve_csne(**inp, pieces=qr.PLAIN)
        torch.cuda.synchronize()
        conv = (rk <= RNORM_TOL) & (rp <= RNORM_TOL)
        scale = max(float(wp.abs().max()), 1.0)
        solve_err = max(float((wk - wp)[conv].abs().max()),
                        float((wnk - wnp)[conv].abs().max())) / scale \
            if conv.any() else 0.0
        same_set = bool(torch.equal(rk > RNORM_TOL, rp > RNORM_TOL))
        solve = dict(head, max_scaled_err=solve_err, same_fallback_set=same_set,
                     n_unconverged_kernel=int((rk > RNORM_TOL).sum()),
                     n_unconverged_plain=int((rp > RNORM_TOL).sum()))
        print("# gls_solve_csne " + json.dumps(solve), flush=True)
        check(solve_err <= TOL_KERNEL, f"gls_solve_csne through the kernels "
                                       f"vs plain: {solve}")
        check(same_set, f"gls_solve_csne: kernel and plain rnorm > "
                        f"{RNORM_TOL} sets differ: {solve}")
        del wk, wnk, rk, wp, wnp, rp

        # qr_r on the route's A; R is that of Ar, A with an identity row
        # per dead column, which the kernel never builds
        A, _ = csne_system(**{k: v for k, v in inp.items() if k != "nm"})
        del inp
        Ar = qr.with_dead_rows(A)
        _, m, n = A.shape
        Rk, Rp = qr.qr_r(A), qr.qr_r_reference(A)
        torch.cuda.synchronize()
        # backward error: how far R^T R is from Ar^T Ar, per node
        bk, bp = (qr.gram_backward_error(R, Ar) for R in (Rk, Rp))
        flags = [qr.r_diag_quality(R) < 1e-6 for R in (Rk, Rp)]
        path = qr.library.get().qr_r_path(m, n)
        row = dict(head, m=m, n=n, path=path, backward_error=bk,
                   plain_backward_error=bp,
                   n_r_diag_flagged=int(flags[0].sum()),
                   max_entry_err_over_r=scaled_err(Rk, Rp, Rp),
                   max_abs_err=float((Rk - Rp).abs().max()),
                   ms=cuda_ms(lambda: qr.qr_r(A), 3),
                   plain_ms=cuda_ms(lambda: qr.qr_r_reference(A), 1),
                   library_ms=cuda_ms(lambda: torch.linalg.qr(Ar, mode="r"),
                                      1))
        # each body: its time, and what its launch holds on an SM
        for p, label in ((2, "register"), (1, "shared")):
            if p == 2 and path != 2:       # no register tile for the class
                continue
            Rb = qr.qr_r(A, path=p)
            row[f"{label}_backward_error"] = qr.gram_backward_error(Rb, Ar)
            row[f"{label}_ms"] = cuda_ms(lambda: qr.qr_r(A, path=p), 3)
            row[f"{label}_occupancy"] = qr.occupancy(m, n, p)
            check(row[f"{label}_backward_error"] <= QR_RATIO * bp,
                  f"qr_r {label} body: backward error > {QR_RATIO} x plain "
                  f"{bp:.3e}: {row}")
            del Rb
        row["bound_ms"], row["bound_by"] = bound(*qr_work(Ar), PEAK_FP64)
        print("# qr_r " + json.dumps(row), flush=True)
        check(bk <= QR_RATIO * bp, f"qr_r backward error {bk:.3e} > "
                                   f"{QR_RATIO} x plain {bp:.3e}: {row}")
        check(torch.equal(*flags), f"qr_r kernel and plain version flag "
                                   f"different nodes: {row}")
        rows["qr_r"].append(row)
        del Ar, Rp

        # sne_solve on e_n, on the route's residual and on a random b
        b = torch.zeros((B, n), dtype=f64, device=A.device)
        b[:, n - 1] = 1.0
        rhs = {"e_n": b, "residual": b - mul_G(A, qr.sne_solve(Rk, b)),
               "random": torch.randn((B, n), dtype=f64, device=A.device,
                                     generator=torch.Generator(
                                         device=A.device).manual_seed(0))}
        del A
        row = dict(head, n=n, path=qr.library.get().sne_solve_path(n),
                   max_abs_err=0.0)
        for label, bb in rhs.items():
            yk, yp = qr.sne_solve(Rk, bb), qr.sne_solve_reference(Rk, bb)
            rk_, rp_ = (qr.sne_residual(Rk, y, bb) for y in (yk, yp))
            row[f"{label}_residual"], row[f"{label}_plain_residual"] = rk_, rp_
            row["max_abs_err"] = max(row["max_abs_err"],
                                     float((yk - yp).abs().max()))
            check(rk_ <= QR_RATIO * rp_,
                  f"sne_solve on {label}: residual {rk_:.3e} > {QR_RATIO} x "
                  f"plain {rp_:.3e} in {head}")
        # each body on the random b: its residual, time and launch on an SM
        bb = rhs["random"]
        for p, label in ((2, "warp"), (1, "global")):
            if p == 2 and row["path"] != 2:  # the triangle passes shared memory
                continue
            res = qr.sne_residual(Rk, qr.sne_solve(Rk, bb, path=p), bb)
            row[f"{label}_random_residual"] = res
            row[f"{label}_ms"] = cuda_ms(lambda: qr.sne_solve(Rk, b, path=p),
                                         5)
            row[f"{label}_occupancy"] = qr.sne_solve_occupancy(n, p)
            check(res <= QR_RATIO * row["random_plain_residual"],
                  f"sne_solve {label} body: residual {res:.3e} > "
                  f"{QR_RATIO} x plain: {row}")
        row.update(ms=cuda_ms(lambda: qr.sne_solve(Rk, b), 5),
                   plain_ms=cuda_ms(lambda: qr.sne_solve_reference(Rk, b), 2),
                   library_ms=cuda_ms(lambda: torch.cholesky_solve(
                       b[:, :, None], Rk, upper=True), 5))
        # the triangle of R read, b read and y written
        row["bound_ms"], row["bound_by"] = bound(
            B * 2 * n * n, B * (n * (n + 1) // 2 + 2 * n) * 8, PEAK_FP64)
        print("# sne_solve " + json.dumps(row), flush=True)
        rows["sne_solve"].append(row)
        del Rk, rhs, b
    return rows


def wide_routes(interp, tp, classes):
    """Phase 4e: a class too wide for shared memory on the unfused and
    solver="pallas" routes; padding a real chunk to (E, F) = (64, 96)
    must not change its weights."""
    from ninpol_tpu_torch._methods.gls import (gls_gather, gls_solve_csne,
                                               gls_solve_unfused)
    from ninpol_tpu_torch.ops import cholqr as cq
    from ninpol_tpu_torch.ops import qr

    dgrid = interp.device_grid
    _, face_table, nflag = interp.gls.plan(
        dgrid, interp.cells_data, interp.points_data,
        interp.variable_to_index, "u", tp)
    c = classes[-1]
    nodes = torch.as_tensor(c["nodes"][:2048], device=dgrid.device)
    inp, _ = gls_gather(dgrid, face_table, nflag, nodes, c["E"], c["F"],
                        c["with_neumann"], tau_guard="norm")
    wide = pad_class(inp, 64, 96)
    n, m = 3 * 64 + 1, 64 + (4 if c["with_neumann"] else 3) * 96
    ws = {k: getattr(cq.library.get(), f"{k}_workspace_floats")(n)
          for k in SOLVE_KERNELS}
    ws["qr_r"] = qr.library.get().qr_r_workspace_doubles(m, n)
    check(ws["chol_linv_f32"] > 0 and ws["round2_gram_f32"] > 0
          and ws["qr_r"] > 0, f"(64, 96) unexpectedly fits: {ws}")
    for label, solve in (("shard_geometry", gls_solve_unfused),
                         ("pallas", gls_solve_csne)):
        w, wn, rn = solve(**inp)
        w2, wn2, rn2 = solve(**wide)
        torch.cuda.synchronize()
        scale = max(float(w.abs().max()), 1.0)
        err = max(float((w2[:, :c["E"]] - w).abs().max()),
                  float((wn2 - wn).abs().max()),
                  float(w2[:, c["E"]:].abs().max()))
        same = bool(torch.equal(rn > RNORM_TOL, rn2 > RNORM_TOL))
        stats = {"route": label, "E": c["E"], "F": c["F"],
                 "with_neumann": c["with_neumann"], "nodes": len(nodes),
                 "m": m, "n": n, "workspace_per_node": ws,
                 "max_scaled_err": err / scale, "same_fallback_set": same,
                 "n_unconverged": int((rn2 > RNORM_TOL).sum())}
        print("# wide class " + json.dumps(stats), flush=True)
        check(err / scale <= TOL_KERNEL, f"wide class differs: {stats}")
        check(same, f"wide class changes the fallback set: {stats}")
        del w, wn, rn, w2, wn2, rn2


def main_path(interp, tp, classes, label):
    """Phase 5 (5b, 5c): the public entry points of one route, counting
    every kernel's launches and every plain version's calls."""
    from ninpol_tpu_torch.ops import cholqr as cq
    from ninpol_tpu_torch.ops import gls_solve as gs
    from ninpol_tpu_torch.ops import qr

    wrappers = {"gls_solve": gs.gls_solve,
                **{k: getattr(cq, k) for k in SOLVE_KERNELS},
                "qr_r": qr.qr_r, "sne_solve": qr.sne_solve}
    plain = ([(gs, "gls_solve_reference")]
             + [(cq, f"{k}_reference") for k in SOLVE_KERNELS]
             + [(qr, "qr_r_reference"), (qr, "sne_solve_reference")])
    plain_calls = []
    saved = [(mod, name, getattr(mod, name)) for mod, name in plain]

    def counting(fn, name):
        def wrapped(*a, **k):
            plain_calls.append(name)
            return fn(*a, **k)
        return wrapped

    for mod, name, fn in saved:
        setattr(mod, name, counting(fn, name))
    chunks = sum(-(-len(c["nodes"]) // c["chunk"]) for c in classes)
    for w in wrappers.values():
        w.launches = 0
    try:
        t0 = time.perf_counter()
        W, NW = interp.prepare_interpolator("gls", "u", tp)
        warm_s = time.perf_counter() - t0
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wdev = interp.prepare_interpolator("gls", "u", tp,
                                               device_out=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        n_bad = interp.gls.last_n_bad
        t0 = time.perf_counter()
        csr, _ = interp.interpolate("u", "gls")
        csr_s = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    runs = 5            # warm-up, 3 timed, interpolate
    want = {k: runs * chunks * PER_CHUNK[label].get(k, 0) for k in wrappers}
    check(launches == want,
          f"{label}: kernel launches {launches} != {want} ({runs} runs x "
          f"{chunks} chunks): some class did not go through the kernels")
    check(not plain_calls, f"{label}: plain versions called on the main "
                           f"path: {sorted(set(plain_calls))}")
    # a wrong preconditioner only stops nodes converging, and the exact
    # fallback would then hide it behind right weights
    check(n_bad <= MAX_BAD, f"{label}: {n_bad} nodes fell back to the "
                            f"exact solve (limit {MAX_BAD})")
    check(torch.isfinite(wdev).all().item(), f"{label}: non-finite weights")
    check(tuple(wdev.shape) == (len(tp), W.shape[1] + 1),
          f"{label}: device_out shape {tuple(wdev.shape)}")
    host = wdev.cpu().numpy()
    gap = max(np.abs(host[:, :-1] - W).max(), np.abs(host[:, -1] - NW).max())
    check(gap <= 1e-12 * max(np.abs(W).max(), 1.0),
          f"{label}: device_out differs from host delivery by {gap:.3e}")
    check(csr.shape == (len(tp), interp.grid.n_elems), f"{label}: CSR shape")
    t = min(times)
    stats = {"warmup_s": warm_s, "device_out_s": times, "best_s": t,
             "mnodes_per_s": len(tp) / t / 1e6, "n_bad": n_bad,
             "interpolate_s": csr_s, "csr_nnz": int(csr.nnz),
             "launches": launches, "chunks_per_run": chunks}
    print(f"# main path {label} " + json.dumps(stats), flush=True)
    return W, NW, stats


def profile_main_path(interp, tp, label):
    """One more device_out run under torch.profiler: device busy share
    and the kernels that take the device time (after the launch count
    was read, so these launches are not counted)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        interp.prepare_interpolator("gls", "u", tp, device_out=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    stats = {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
             "idle_share": 1.0 - busy_ms / (wall * 1e3),
             "top": [{"name": k[0][:80], "ms": k[1], "calls": k[2]}
                     for k in kernels[:8]]}
    print(f"# profile {label} " + json.dumps(stats), flush=True)
    return stats


def oracle_check(interp, routes):
    """Phase 6: sampled nodes of each route's weights against the scipy
    dgels oracle (computed once)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from utils.oracle import gls_oracle

    grid = interp.grid
    v2i = interp.variable_to_index
    nflag = interp.points_data[v2i["points"]["neumann_flag_u"]].astype(int)
    rng = np.random.default_rng(1)
    interior = np.nonzero(~grid.boundary_points.astype(bool))[0]
    neumann = np.nonzero(nflag)[0]
    si = rng.choice(interior, min(128, len(interior)), replace=False)
    sn = rng.choice(neumann, min(128, len(neumann)), replace=False)
    sub = np.concatenate([si, sn])
    t0 = time.perf_counter()
    Wo, NWo, cond = gls_oracle(
        grid, sub, interp.cells_data[v2i["cells"]["permeability"]],
        interp.cells_data[v2i["cells"]["diff_mag"]], nflag,
        interp.points_data[v2i["points"]["neumann_u"]], return_cond=True)
    oracle_s = time.perf_counter() - t0
    ok = cond < 1e7
    check(ok.sum() > 0, "no sampled node with cond < 1e7")
    scale = max(np.abs(Wo[ok]).max(), 1.0)
    out = {}
    for label, (W, NW) in routes.items():
        ncols = min(W.shape[1], Wo.shape[1])
        err = max(np.abs(W[sub][ok][:, :ncols] - Wo[ok][:, :ncols]).max(),
                  np.abs(NW[sub][ok] - NWo[ok]).max()) / scale
        rowsum = np.abs(W[si].sum(axis=1) - 1.0).max()
        stats = {"sampled": len(sub), "cond_ok": int(ok.sum()),
                 "max_rel_err": float(err),
                 "interior_rowsum_err": float(rowsum), "oracle_s": oracle_s}
        print(f"# oracle {label} " + json.dumps(stats), flush=True)
        check(err <= TOL_ORACLE,
              f"{label}: max rel err vs dgels {err:.3e} > {TOL_ORACLE}")
        check(rowsum <= TOL_ORACLE,
              f"{label}: interior row sums off by {rowsum:.3e}")
        out[label] = stats
    return out


def build_kernels():
    """Phase 2: one nvcc per kernel source, all started together."""
    from ninpol_tpu_torch.ops import cholqr as cq
    from ninpol_tpu_torch.ops import gls_solve as gs
    from ninpol_tpu_torch.ops import qr

    libs = (gs.library, cq.library, qr.library)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as ex:
        for f in [ex.submit(lib.get) for lib in libs]:
            f.result()
    print(f"# kernel build: {time.perf_counter() - t0:.2f} s", flush=True)
    for lib in libs:
        print(f"# {lib.name}.cu: {lib.build_seconds:.2f} s", flush=True)
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"#   {line.strip()}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=68,
                    help="tetra_mesh size (6 n^3 cells); 68 = 1,886,592")
    args = ap.parse_args()

    # ---- 1. the card
    card = card_line()
    print(f"# card: {card}", flush=True)
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    print(f"# python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    # ---- 2. build the kernels
    build_kernels()

    # ---- 3. the problem, once for each route
    t0 = time.perf_counter()
    interp, build_s = build_problem(args.n)
    unfused, _ = build_problem(args.n, shard_geometry=True)
    tp = np.arange(interp.grid.n_points)
    print(f"# mesh: {interp.grid.n_elems} cells, {interp.grid.n_points} "
          f"points; grid build {build_s:.2f} s, both problems "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 4. kernels vs plain versions
    classes, rows = kernel_vs_plain(interp, tp)
    workspace_path(interp, tp, classes)
    classes_u, rows_u = cholqr_vs_plain(unfused, tp)
    rows_q = csne_vs_plain(interp, tp)
    wide_routes(interp, tp, classes)

    # ---- 5. main path, the three routes
    W, NW, stats = main_path(interp, tp, classes, "fused")
    profile_main_path(interp, tp, "fused")
    Wu, NWu, stats_u = main_path(unfused, tp, classes_u, "shard_geometry")
    profile_main_path(unfused, tp, "shard_geometry")
    interp.gls.solver = "pallas"
    Wc, NWc, stats_c = main_path(interp, tp, classes, "pallas")
    profile_main_path(interp, tp, "pallas")
    interp.gls.solver = "auto"
    print("# routes " + json.dumps({
        "fused_best_s": stats["best_s"],
        "shard_geometry_best_s": stats_u["best_s"],
        "pallas_best_s": stats_c["best_s"],
        "shard_geometry_over_fused": stats_u["best_s"] / stats["best_s"],
        "pallas_over_fused": stats_c["best_s"] / stats["best_s"],
        "n_bad": {"fused": stats["n_bad"],
                  "shard_geometry": stats_u["n_bad"],
                  "pallas": stats_c["n_bad"]}}), flush=True)

    # ---- 6. oracle, and the routes against each other
    oracle_check(interp, {"fused": (W, NW), "shard_geometry": (Wu, NWu),
                          "pallas": (Wc, NWc)})
    scale = max(np.abs(W).max(), 1.0)
    for label, (Wx, NWx) in (("shard_geometry", (Wu, NWu)),
                             ("pallas", (Wc, NWc))):
        gap = max(np.abs(Wx - W).max(), np.abs(NWx - NW).max()) / scale
        print(f"# {label} vs fused " + json.dumps(
            {"max_scaled_diff": float(gap)}), flush=True)
        check(gap <= TOL_ORACLE, f"{label} weights differ from the fused "
                                 f"route's by {gap:.3e} scaled")

    def entry(name, source, replaces, launches, rows, top,
              tpu_file="pallas_chol.py"):
        return {"name": name, "route": "cuda",
                "source": f"ninpol_tpu_torch/csrc/{source}",
                "replaces": f"ninpol_tpu/ops/{tpu_file}:{replaces}",
                "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                **{k: top[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
                "timed_class": {k: top[k] for k in (
                    "E", "F", "with_neumann", "chunk")},
                "classes": rows}

    top = max(rows, key=lambda r: r["nodes_in_class"])
    kernels = [entry("gls_solve", "gls_solve.cu", 849,
                     stats["launches"]["gls_solve"], rows, top)]
    for name, line in (("gram_f32", 77), ("chol_linv_f32", 984),
                       ("round2_gram_f32", 118), ("prec_apply_f32", 900)):
        # the largest class's chunk; for chol_linv its first call (G1)
        top_u = max(rows_u[name], key=lambda r: (r["chunk"],
                                                 not r.get("mul_right")))
        kernels.append(entry(name, "cholqr.cu", line,
                             stats_u["launches"][name], rows_u[name], top_u))
    for name, line in (("qr_r", 122), ("sne_solve", 207)):
        top_q = max(rows_q[name], key=lambda r: r["chunk"])
        kernels.append(entry(name, "qr.cu", line, stats_c["launches"][name],
                             rows_q[name], top_q, tpu_file="pallas_qr.py"))
    print(card, flush=True)            # nvidia-smi name, power.limit
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
