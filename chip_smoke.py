"""On-card smoke check of the PyTorch port (ninpol_tpu_torch) on one GPU.

Drives the port's GLS main path — the path bench.py times for ninpol_tpu:
GLS weights with Neumann nodes, on the 1,886,592-cell tetrahedral mesh,
through the public Interpolator API — and checks it:

  1. prints the card (nvidia-smi name, power limit); requires CUDA;
  2. builds the solve kernel (csrc/gls_solve.cu) with nvcc;
  3. builds bench.py's problem with the port's own meshgen: tetra_mesh(68),
     an ALH-style full-tensor K, u = x^2 + y^2 + z^2, a seeded (rng 0)
     Dirichlet/Neumann boundary split;
  4. kernel vs plain PyTorch version on one chunk of every
     (E, F, with_neumann) class of the plan: w and wn agree to <= 1e-10
     scaled on the nodes both call converged, and the rnorm > 1e-11 sets
     agree; prints both times;
     then one chunk padded to (E, F) = (64, 96), too wide for shared
     memory, so the kernel runs from its device workspace: same weights;
  5. the main path: a warm-up prepare_interpolator, 3 timed device_out
     runs (torch.cuda.synchronize), interpolate() -> CSR; prints seconds,
     Mnodes/s, n_bad and the kernel launch count, which must equal one
     launch per chunk per run (so every class went through the kernel),
     with no plain-version call; then one more run under torch.profiler
     (device busy share, top kernels);
  6. the delivered weights against the scipy dgels oracle on 256 sampled
     nodes (128 interior, 128 Neumann; cond < 1e7): max scaled error
     <= 1e-10, and interior rows sum to 1.

Any failing phase raises (non-zero exit).  The last two lines are the
kernels JSON line and {"ok": true, "device": {...}}.

Run: python3 chip_smoke.py            (options: --n N, the mesh size)
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL_KERNEL = 1e-10     # kernel vs plain version, scaled by max |w|
TOL_ORACLE = 1e-10     # delivered weights vs dgels, scaled (bench.py)
RNORM_TOL = 1e-11      # the exact-fallback threshold (fallback_tol)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def build_problem(n):
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

    interp = Interpolator()
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
        inp, _ = gls_gather(dgrid, face_table, nflag, nodes, c["E"], c["F"],
                            c["with_neumann"])
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
        row = {"E": c["E"], "F": c["F"], "with_neumann": c["with_neumann"],
               "nodes_in_class": len(c["nodes"]), "chunk": B,
               "max_abs_err": err, "max_scaled_err": err / scale,
               "n_unconverged_kernel": int((rk > RNORM_TOL).sum()),
               "n_unconverged_plain": int((rp > RNORM_TOL).sum()),
               "same_fallback_set": same_set, "ms": ms, "plain_ms": plain_ms}
        print("# class " + json.dumps(row), flush=True)
        check(err / scale <= TOL_KERNEL,
              f"kernel vs plain: scaled error {err / scale:.3e} > "
              f"{TOL_KERNEL} in class {row}")
        check(same_set, f"kernel and plain rnorm > {RNORM_TOL} sets differ "
                        f"in class {row}")
        rows.append(row)
    return classes, rows


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


def main_path(interp, tp, classes):
    """Phase 5: the public entry points, counting kernel launches."""
    from ninpol_tpu_torch.ops import gls_solve as gs

    plain_calls = []
    plain = gs.gls_solve_reference

    def counting_plain(*a, **k):
        plain_calls.append(1)
        return plain(*a, **k)

    chunks = sum(-(-len(c["nodes"]) // c["chunk"]) for c in classes)
    gs.gls_solve_reference = counting_plain
    gs.gls_solve.launches = 0
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
        launches = gs.gls_solve.launches
    finally:
        gs.gls_solve_reference = plain
    runs = 5            # warm-up, 3 timed, interpolate
    check(launches == runs * chunks,
          f"kernel launches {launches} != {runs} runs x {chunks} chunks: "
          "some class did not go through the kernel")
    check(not plain_calls, f"plain version called {len(plain_calls)} "
                           "times on the main path")
    check(torch.isfinite(wdev).all().item(), "non-finite weights")
    check(tuple(wdev.shape) == (len(tp), W.shape[1] + 1),
          f"device_out shape {tuple(wdev.shape)}")
    host = wdev.cpu().numpy()
    gap = max(np.abs(host[:, :-1] - W).max(), np.abs(host[:, -1] - NW).max())
    check(gap <= 1e-12 * max(np.abs(W).max(), 1.0),
          f"device_out differs from host delivery by {gap:.3e}")
    check(csr.shape == (len(tp), interp.grid.n_elems), "CSR shape")
    t = min(times)
    stats = {"warmup_s": warm_s, "device_out_s": times, "best_s": t,
             "mnodes_per_s": len(tp) / t / 1e6, "n_bad": n_bad,
             "interpolate_s": csr_s, "csr_nnz": int(csr.nnz),
             "launches": launches, "chunks_per_run": chunks}
    print("# main path " + json.dumps(stats), flush=True)
    return W, NW, stats


def profile_main_path(interp, tp):
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
    print("# profile " + json.dumps(stats), flush=True)
    return stats


def oracle_check(interp, W, NW):
    """Phase 6: sampled nodes against the scipy dgels oracle."""
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
    ok = cond < 1e7
    scale = max(np.abs(Wo[ok]).max(), 1.0)
    ncols = min(W.shape[1], Wo.shape[1])
    err = max(np.abs(W[sub][ok][:, :ncols] - Wo[ok][:, :ncols]).max(),
              np.abs(NW[sub][ok] - NWo[ok]).max()) / scale
    rowsum = np.abs(W[si].sum(axis=1) - 1.0).max()
    stats = {"sampled": len(sub), "cond_ok": int(ok.sum()),
             "max_rel_err": float(err), "interior_rowsum_err": float(rowsum),
             "oracle_s": time.perf_counter() - t0}
    print("# oracle " + json.dumps(stats), flush=True)
    check(ok.sum() > 0, "no sampled node with cond < 1e7")
    check(err <= TOL_ORACLE, f"max rel err vs dgels {err:.3e} > {TOL_ORACLE}")
    check(rowsum <= TOL_ORACLE, f"interior row sums off by {rowsum:.3e}")
    return stats


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

    # ---- 2. build the kernel
    from ninpol_tpu_torch.ops import gls_solve as gs
    gs.library.get()
    print(f"# kernel build: {gs.library.build_seconds:.2f} s", flush=True)
    for line in gs.library.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"#   {line.strip()}", flush=True)

    # ---- 3. the problem
    t0 = time.perf_counter()
    interp, build_s = build_problem(args.n)
    tp = np.arange(interp.grid.n_points)
    print(f"# mesh: {interp.grid.n_elems} cells, {interp.grid.n_points} "
          f"points; grid build {build_s:.2f} s, problem "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 4. kernel vs plain version
    classes, rows = kernel_vs_plain(interp, tp)
    workspace_path(interp, tp, classes)

    # ---- 5. main path
    W, NW, stats = main_path(interp, tp, classes)
    profile_main_path(interp, tp)

    # ---- 6. oracle
    oracle_check(interp, W, NW)

    top = max(rows, key=lambda r: r["nodes_in_class"])
    print(card, flush=True)            # nvidia-smi name, power.limit
    print(json.dumps({"kernels": [{
        "name": "gls_solve", "route": "cuda",
        "source": "ninpol_tpu_torch/csrc/gls_solve.cu",
        "replaces": "ninpol_tpu/ops/pallas_chol.py:849",
        "launches": stats["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "timed_class": {k: top[k] for k in ("E", "F", "with_neumann",
                                            "chunk")},
        "classes": rows}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
