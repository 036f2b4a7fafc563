"""Kernel 1's stage probe: where the time goes inside the fused GLS solve
kernel (csrc/gls_solve.cu) on the card.

The counterpart of the TPU probes in the repo's tools/: there,
kernel_stages.py wraps the fused kernel's stage helpers one at a time,
r5_floor_probe.py times its per-step floor, and the other probes try
design alternatives of the same stages.  Here the kernel's own stage-cut
instances (ops/gls_solve.py::gls_solve_stage) run the production code up
to a stage and stop, so a cut's time is the kernel's time up to that
stage, on the route's inputs and at the production kernel's occupancy.

For one chunk of each stencil class of the default route's plan, and
for each ``rounds`` instance at its route's sweeps, it gives per cut the
cumulative ms (the best of REPS CUDA-event timings of one launch, after
a warm-up), the stage's ms (the difference from the cut before),
the stage's bound (``problem.bound`` of its FLOPs and device bytes) and
its share of the whole kernel; and beside them the unfused route's
kernels (ops/cholqr.py) that compute the same stages, timed in the same
run on the same inputs.  Each cut is also held to its plain version
(``cut_errors``): its checksum against gls_solve_reference(...,
stop=...) on the same tensors, within CUT_TOL.

Run on the card (the kernels are built from csrc/ on first use):

    python -m ninpol_tpu_torch.tools.kernel_stages [--n 68]

It prints ``#`` lines, then one JSON line ``{"kernel_stages": ...}``.
Nothing falls back: a cut that does not build or launch raises, and one
whose checksum is past its tolerance fails the run after that line.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from .problem import bound, build_problem

# timed launches of each cut or kernel, after one warm-up
REPS = 5
# each cut's checksum against the plain version's, per active node, over
# a scale: the float64 sums of the inputs and of A to 1e-12 of the sum
# (another summation order); the float32 stages to 1e-5 of the same sum
# of their magnitude (|As|^T |As|, |L1^-1|, |As| |L1^-1|^T, |Q|^T |Q|,
# |Lc|: another order of each product, as the cholqr kernels are held);
# y after the sweeps to 1e-10 of the sum (the solve's parity bar), on the
# nodes where the plain version converges (rnorm <= RNORM_TOL)
CUT_TOL = {"floor": 1e-12, "rows": 1e-12, "gram1": 1e-5, "chol1": 1e-5,
           "q": 1e-5, "gram2": 1e-5, "chol2": 1e-5, "sweeps": 1e-10}
RNORM_TOL = 1e-11
# L1^-1's forward error grows with G1's condition number, so chol1 is
# also allowed CHOL_RATIO times the plain version's own error: its
# checksum's distance from that of the float64 inverse factor of the same
# G1 (chip_smoke.py holds chol_linv_f32 to its plain version alike)
CHOL_RATIO = 10.0
# the sweep counts tried for the sweeps cut's check, after the route's,
# until the plain version converges on every active node that is not
# flagged (where the cut falls does not depend on the count)
CHECK_SWEEPS = (10, 20, 40, 80, 160, 320, 640)


def route_sweeps(n_refine, rounds):
    """The sweeps the default route gives the kernel's ``rounds``
    instance (_methods/gls.py: n_refine + 1, at least 2; two more at one
    round)."""
    return max(n_refine + 1, 2) + (2 if rounds == 1 else 0)


def chunk_inputs(interp, target_points, variable="u"):
    """The first chunk of each stencil class of the GLS plan for
    ``target_points``, gathered as the default route gathers it:
    [(class, solve inputs, n_elem)]."""
    from .._methods.gls import gls_gather

    dgrid = interp.device_grid
    classes, face_table, nflag = interp.gls.plan(
        dgrid, interp.cells_data, interp.points_data,
        interp.variable_to_index, variable, target_points)
    out = []
    for c in classes:
        B = min(c["chunk"], len(c["nodes"]))
        nodes = torch.as_tensor(c["nodes"][:B], device=dgrid.device)
        inp, n_elem = gls_gather(dgrid, face_table, nflag, nodes, c["E"],
                                 c["F"], c["with_neumann"])
        out.append((c, inp, n_elem))
    return out


def best_ms(fn):
    """The least device ms of one ``fn()`` over REPS runs, each between
    two CUDA events, after a warm-up run."""
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
    for start, stop in events:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return min(start.elapsed_time(stop) for start, stop in events)


def stage_work(inp, rounds, sweeps):
    """{stage: (FP32 FLOPs, FP64 FLOPs, device bytes)} of the chunk, what
    its data needs stage by stage (a node that is not active stops after
    the floor):
      floor   every input read and every output written once;
      rows    none: A is assembled in shared memory;
      gram1   column norms and scaling, 3 m n, and G1 on its upper
              triangle, m n (n + 1);
      chol1   the clamped Cholesky factorization and the triangular
              inverse, 2 n^3 / 3 (chol2 alike: L2 and L2^-1 L1^-1);
      q       Q = A L1^-T, L1^-T triangular: m n (n + 1); gram2 alike;
      sweeps  sweeps + 1 applications of M in float32 (two triangular
              products, 2 n (n + 1)) and ``sweeps`` float64 residuals
              A^T (A y), 4 nnz(A) each, nnz(A) from the node's cells and
              faces (the kernel applies A structurally);
      all     the outputs' A y, 2 nnz(A) in float64."""
    from ..ops.gls_solve import incidence, node_active

    B, E, _ = inp["dk"].shape
    F = inp["l1"].shape[1]
    wneu = inp["lb"] is not None
    m, n = E + (4 if wneu else 3) * F, 3 * E + 1
    S1, S2, Sb = incidence(inp["pair"], inp["ks"], inp["cv"], inp["fv"],
                           inp["isneu"])
    active = node_active(inp["pair"], inp["fv"], inp["valid"])
    # nonzeros of A: 3 gradient entries and the constant in a valid cell's
    # row, 3 rows x 3 components a face cell, 3 a Neumann row's owner
    nnz = (4 * inp["cv"].sum(dim=1) + 9 * (S1.sum(dim=(1, 2))
                                           + S2.sum(dim=(1, 2)))
           + (3 * Sb.sum(dim=(1, 2)) if wneu else 0))
    nnz = float(nnz[active].sum())
    Ba = int(active.sum())
    nbytes = (sum(x.nbytes for x in inp.values() if x is not None)
              + B * (E + 2) * 8)
    product = Ba * m * n * (n + 1)
    factor = Ba * 2 * n ** 3 / 3
    work = {"floor": (0.0, 0.0, nbytes), "rows": (0.0, 0.0, 0),
            "gram1": (Ba * 3 * m * n + product, 0.0, 0),
            "chol1": (factor, 0.0, 0), "q": (product, 0.0, 0),
            "gram2": (product, 0.0, 0), "chol2": (factor, 0.0, 0),
            "sweeps": ((sweeps + 1) * Ba * 2 * n * (n + 1),
                       sweeps * 4 * nnz, 0),
            "all": (0.0, 2 * nnz, 0)}
    if rounds < 2:
        for k in ("q", "gram2", "chol2"):
            del work[k]
    return work


def cut_errors(inp, rounds, sweeps, run=None, stops=None):
    """Each cut of the kernel's ``rounds`` instance (``stops``: all but
    "all", which chip_smoke.py holds to gls_solve bit for bit) on the
    chunk, held to its plain version, gls_solve_reference(..., stop=...),
    on the same tensors: {stop: {"max_err": the largest error of an
    active node's checksum over its scale (CUT_TOL's comment), "tol": its
    tolerance, "nodes": the nodes held}}; chol1 also gives "plain_err"
    (CHOL_RATIO), the sweeps cut "sweeps", the count it was held at (the
    route's ``sweeps`` or, until the plain version converges, the next of
    CHECK_SWEEPS).  ``run(stop, sweeps)`` gives the cut's (w, wn, rnorm);
    by default gls_solve_stage.  Raises when a cut's w or wn is not zero,
    or an inactive node's checksum is not zero."""
    from ..ops import cholqr as cq
    from ..ops import gls_solve as gs

    if run is None:
        def run(stop, sweeps):
            return gs.gls_solve_stage(stop, **inp, sweeps=sweeps,
                                      rounds=rounds)
    stops = gs.stages(rounds)[:-1] if stops is None else stops
    S1, S2, Sb = gs.incidence(inp["pair"], inp["ks"], inp["cv"], inp["fv"],
                              inp["isneu"])
    active = gs.node_active(inp["pair"], inp["fv"], inp["valid"])
    A = gs.assemble(inp["dk"], inp["l1"], inp["l2"], inp["t1m"], inp["tt"],
                    inp["lb"], S1, S2, Sb, inp["cv"], active)
    pc = cq.cholqr_factors(A, cq.PLAIN, rounds=rounds)
    del A, S1, S2, Sb
    aAs, aLi1 = pc["As"].abs(), pc["Li1"].abs()
    aQ = aAs @ aLi1.transpose(1, 2)

    def total(x):
        return x.double().flatten(1).sum(dim=1)

    scales = {"gram1": lambda: total(aAs.transpose(1, 2) @ aAs),
              "chol1": lambda: total(aLi1), "q": lambda: total(aQ),
              "gram2": lambda: total(aQ.transpose(1, 2) @ aQ),
              "chol2": lambda: total(pc["Lc"].abs())}
    out = {}
    for stop in stops:
        at = sweeps
        held = active
        if stop == "sweeps":
            for at in (sweeps, *(s for s in CHECK_SWEEPS if s > sweeps)):
                _, _, rn = gs.gls_solve_reference(**inp, sweeps=at,
                                                  rounds=rounds)
                held = active & (rn <= RNORM_TOL)
                if bool((held | ~active | pc["sick"]).all()):
                    break
        w, wn, got = run(stop, at)
        _, _, ref = gs.gls_solve_reference(**inp, sweeps=at, rounds=rounds,
                                           stop=stop)
        if w.any() or wn.any():
            raise RuntimeError(f"stage cut {stop!r} (rounds={rounds}) wrote "
                               f"nonzero w or wn")
        if got[~active].any() or ref[~active].any():
            raise RuntimeError(f"stage cut {stop!r} (rounds={rounds}) gave "
                               f"an inactive node a nonzero checksum")
        scale = (scales[stop]() if stop in scales
                 else ref.abs().clamp_min(1.0))

        def worst(x):
            err = ((x - ref).abs() / scale)[held]
            return float(err.max()) if len(err) else 0.0

        out[stop] = {"max_err": worst(got), "tol": CUT_TOL[stop],
                     "nodes": int(held.sum())}
        if stop == "chol1":
            exact = total(cq.chol_linv_f32_reference(pc["G1"].double()))
            out[stop]["plain_err"] = worst(exact)
            out[stop]["tol"] = max(CUT_TOL[stop],
                                   CHOL_RATIO * out[stop]["plain_err"])
        if stop == "sweeps":
            out[stop]["sweeps"] = at
    return out


def failed_cuts(table):
    """The cuts of a ``probe`` table whose checksum is past its
    tolerance, as messages."""
    bad = []
    for row in table:
        for rounds, r in row["rounds"].items():
            for cut in r["cuts"]:
                if "max_err" in cut and not cut["max_err"] <= cut["tol"]:
                    bad.append(f"({row['E']}, {row['F']}) rounds={rounds} "
                               f"cut {cut['stop']}: checksum error "
                               f"{cut['max_err']:.3e} > {cut['tol']:.0e}")
    return bad


def time_cuts(inp, rounds, sweeps):
    """Each cut of the kernel's ``rounds`` instance on the chunk: its
    cumulative ms, the stage's ms, bound and share of the whole kernel."""
    from ..ops import gls_solve as gs

    work = stage_work(inp, rounds, sweeps)
    cuts, before = [], 0.0
    for stop in gs.stages(rounds):
        ms = best_ms(lambda: gs.gls_solve_stage(
            stop, **inp, sweeps=sweeps, rounds=rounds))
        f32, f64, nbytes = work[stop]
        bound_ms, bound_by = bound(f32, nbytes, fp64_flops=f64)
        cuts.append({"stop": stop, "ms": ms, "stage_ms": ms - before,
                     "bound_ms": bound_ms, "bound_by": bound_by})
        before = ms
    for cut in cuts:
        cut["share"] = cut["stage_ms"] / before
    return cuts


def time_standalone(inp, rounds, sweeps):
    """The unfused route's kernels on the same chunk (its inputs: the
    equilibrated As and the factors they give), timed as the cuts are:
    {stage: {"kernel": name, "ms": ms}}: gram_f32 for gram1, chol_linv_f32
    for chol1 (and, with L1^-1 as P, chol2), round2_gram_f32 for q and
    gram2 together, prec_apply_f32 sweeps + 1 times for the float32 part
    of the sweeps (the unfused route runs their float64 residuals as
    torch ops)."""
    from ..ops import cholqr as cq
    from ..ops.gls_solve import assemble, incidence, node_active

    S1, S2, Sb = incidence(inp["pair"], inp["ks"], inp["cv"], inp["fv"],
                           inp["isneu"])
    A = assemble(inp["dk"], inp["l1"], inp["l2"], inp["t1m"], inp["tt"],
                 inp["lb"], S1, S2, Sb, inp["cv"],
                 node_active(inp["pair"], inp["fv"], inp["valid"]))
    pc = cq.cholqr_factors(A, cq.KERNELS, rounds=rounds)
    del A, S1, S2, Sb
    As, G1, Li1, G2, Lc = (pc[k] for k in ("As", "G1", "Li1", "G2", "Lc"))
    gen = torch.Generator(device=As.device).manual_seed(0)
    v = torch.randn(Lc.shape[:2], device=As.device, generator=gen)
    out = {"gram1": ("gram_f32", lambda: cq.gram_f32(As)),
           "chol1": ("chol_linv_f32", lambda: cq.chol_linv_f32(G1))}
    if rounds >= 2:
        out["q+gram2"] = ("round2_gram_f32",
                          lambda: cq.round2_gram_f32(As, Li1))
        out["chol2"] = ("chol_linv_f32 (P = L1^-1)",
                        lambda: cq.chol_linv_f32(G2, mul_right=Li1))
    out = {k: {"kernel": name, "ms": best_ms(fn)}
           for k, (name, fn) in out.items()}
    apply_ms = best_ms(lambda: cq.prec_apply_f32(Lc, v))
    out["sweeps"] = {"kernel": f"prec_apply_f32 x {sweeps + 1}",
                     "ms": (sweeps + 1) * apply_ms,
                     "ms_per_call": apply_ms}
    return out


def probe(chunks, n_refine=2):
    """The stage table of each chunk (``chunk_inputs``) and each
    ``rounds`` instance, at the route's sweeps for ``n_refine``, with each
    cut's checksum error against its plain version (``cut_errors``)."""
    from ..ops.gls_solve import node_active

    out = []
    for c, inp, _ in chunks:
        row = {"E": c["E"], "F": c["F"], "with_neumann": c["with_neumann"],
               "nodes_in_class": len(c["nodes"]),
               "chunk": int(inp["dk"].shape[0]),
               "active": int(node_active(inp["pair"], inp["fv"],
                                         inp["valid"]).sum()),
               "rounds": {}}
        for rounds in (2, 1):
            sweeps = route_sweeps(n_refine, rounds)
            cuts = time_cuts(inp, rounds, sweeps)
            errors = cut_errors(inp, rounds, sweeps)
            for cut in cuts:
                cut.update(errors.get(cut["stop"], {}))
            row["rounds"][str(rounds)] = {
                "sweeps": sweeps, "cuts": cuts,
                "standalone": time_standalone(inp, rounds, sweeps)}
        out.append(row)
    return out


def report(table):
    """The stage table as ``#`` lines, one a cut."""
    for row in table:
        for rounds, r in row["rounds"].items():
            print(f"# kernel_stages ({row['E']}, {row['F']}) "
                  f"with_neumann={row['with_neumann']} chunk={row['chunk']}"
                  f" rounds={rounds} sweeps={r['sweeps']}", flush=True)
            for cut in r["cuts"]:
                side = r["standalone"].get(cut["stop"])
                print(f"#   {cut['stop']:>6}: {cut['ms']:9.4f} ms cumulative,"
                      f" stage {cut['stage_ms']:9.4f} ms "
                      f"({100 * cut['share']:5.1f}%), bound "
                      f"{cut['bound_ms']:.4f} ms ({cut['bound_by']})"
                      + (f", checksum error {cut['max_err']:.2e} (tol "
                         f"{cut['tol']:.1e}, {cut['nodes']} nodes)"
                         if "max_err" in cut else "")
                      + (f"; {side['kernel']} {side['ms']:.4f} ms"
                         if side else ""), flush=True)
            if "q+gram2" in r["standalone"]:
                side = r["standalone"]["q+gram2"]
                print(f"#   q + gram2: {side['kernel']} {side['ms']:.4f} ms",
                      flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=68,
                    help="tetra_mesh size (6 n^3 cells); 68 = 1,886,592")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_stages needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"# card: {card}", flush=True)
    interp, _ = build_problem(args.n)
    chunks = chunk_inputs(interp, np.arange(interp.grid.n_points))
    table = probe(chunks, interp.gls.n_refine)
    report(table)
    print(json.dumps({"kernel_stages": {
        "card": card, "mesh": f"tetra_mesh({args.n})", "reps": REPS,
        "classes": table}}), flush=True)
    bad = failed_cuts(table)
    if bad:
        raise SystemExit("\n".join(bad))


if __name__ == "__main__":
    main()
