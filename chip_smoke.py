"""On-card smoke check of the PyTorch port (ninpol_tpu_torch) on one GPU
(phase 9 spans every card there is).

Drives the port's GLS main path — the path bench.py times for ninpol_tpu:
GLS weights with Neumann nodes, on the 1,886,592-cell tetrahedral mesh,
through the public Interpolator API — its unfused route (gls.fused =
False: ninpol_tpu's unfused CholeskyQR2 composition, which
shard_geometry=True takes on a mesh), its solver="pallas"
route (Householder R and corrected semi-normal equations) and its
"refined" route, the fused route's single-round preconditioner
(precond_rounds = 1), and IDW and LS on that mesh and on a 2,097,152-cell
hexahedral one, and checks them all:

  1. prints the card (nvidia-smi name, power limit); requires CUDA;
  2. builds the kernel libraries with nvcc, in parallel:
     csrc/gls_solve.cu (the fused solve, and apart from it its stage
     cuts), csrc/cholqr.cu (gram, chol_linv, round2_gram, prec_apply),
     csrc/qr.cu (qr_r, sne_solve), csrc/factor_probes.cu (phase 11's
     kernels), csrc/mxu_probes.cu (phase 12's) and csrc/input_probes.cu
     (phase 13's);
  3. builds bench.py's problem with the port's own meshgen
     (tools/problem.py): tetra_mesh(68), an ALH-style full-tensor K,
     u = x^2 + y^2 + z^2, a seeded (rng 0) Dirichlet/Neumann boundary
     split; once for each CholeskyQR2 route (the solver="pallas" route
     runs on the fused route's problem);
  4. the solve kernel vs its plain PyTorch version on one chunk of every
     (E, F, with_neumann) class of the plan: w and wn agree to <= 1e-10
     scaled on the nodes both call converged, and the rnorm > 1e-11 sets
     agree; prints both times (the kernel's the least of 5 single
     launches, as phase 10 times), the kernel's dynamic shared memory,
     blocks per SM, registers and local (spill) bytes a thread, and the
     time of torch.linalg.lstsq on the largest class's dense float64
     system;
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
     memory and blocks per SM per class; the two bodies of gram,
     round2_gram (registers, shared memory) and prec_apply (a warp a
     node, shared memory) each held to the same bounds (prec_apply's on
     both vectors) and timed, with each body's occupancy and the one its
     class takes; the Gram products' two bodies give equal results, to
     the bit;
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
     4f. the solve kernel's single-round instance (precond_rounds = 1)
     vs its plain version by phase 4's rule at the route's five sweeps
     (both times), and again at the first of 10, 20, ..., 640 sweeps at
     which the kernel converges every node of the chunk (five leave
     them all above 1e-11 on this mesh), where the plain version must
     converge them all too;
  5. the main path: a warm-up prepare_interpolator, 3 timed device_out
     runs (torch.cuda.synchronize), interpolate() -> CSR; prints seconds,
     Mnodes/s, n_bad (which must be 0) and the kernel launch count, which
     must equal one launch per chunk per run (so every class went through
     the kernel), with no plain-version call; then one more run under
     torch.profiler (device busy share, top kernels);
     5b. the same for the unfused route ("shard_geometry"): per chunk per run
     exactly 1 gram, 2 chol_linv, 1 round2_gram and 4 prec_apply launches,
     no plain-version call and no solve-kernel launch; device-complete
     seconds beside the fused route's; a profiled run;
     5c. the same for solver="pallas": per chunk per run exactly 1 qr_r
     and 2 sne_solve launches and no other kernel's, no plain-version
     call; a profiled run;
     5d. solver="refined" (torch ops, no kernel: ninpol_tpu has no Pallas
     kernel for it): a warm-up and 3 timed runs, no kernel launch and no
     plain-version call; n_bad printed, not bounded; then the solver
     itself on up to 8192 nodes of every class: its converged share at
     the route's two sweeps, and at the first of 3, 4, 8, 16 sweeps that
     converges every node, weights within 1e-10 scaled of the fused
     kernel's;
     5e. the tracing hooks on the fused route's warmed interpolator and the
     full main path: NINPOL_TPU_PHASES=1 on three device_out runs and three
     host-delivered runs of the fused route and three device_out runs of
     the unfused route, each phase line parsed (names in the port's order,
     times not decreasing, n_bad 0 and equal to last_n_bad) and printed
     beside the run's wall time to device completion, each result equal to
     the hooks-off one (phase 5's, 5b's) bit for bit; one fused run with
     NINPOL_TPU_PROFILE set to a fresh temporary directory: exactly one
     *.pt.trace.json, as many gls_solve_kernel events as phase 5 counts
     chunks, each gather, solve and epilogue range once a chunk, the
     result equal bit for bit; prints each range's summed host and device
     ms, the kernels' and copies' busy ms and each CUDA runtime call's
     count and host ms from the trace; then IDW with the profile hook
     (its trace written, its result equal to a hooks-off run's);
  6. the delivered weights of the four routes against the scipy dgels
     oracle on 256 sampled nodes (128 interior, 128 Neumann; cond < 1e7):
     max scaled error <= 1e-10, interior rows sum to 1; and the other
     routes' weights against the fused route's, <= 1e-10 scaled;
  7. the fused route at precond_rounds = 1 on tetra_mesh(20): one solve
     launch per chunk, n_bad and seconds printed, the weights within
     1e-10 scaled of rounds = 2's;
  8. IDW and LS on tetra_mesh(68) and on hexa_mesh(128) (the same K and
     a seeded Neumann split): a warm-up, 3 timed device_out runs,
     interpolate() to CSR and a profiled run each; the card's weights on
     every node against the port's own run on the CPU (IDW <= 1e-13
     absolute; LS <= 1e-11 where |denom| > 1e-8, test_methods.py:50-57),
     and on 2048 sampled nodes against idw_oracle / ls_oracle, same
     bounds; the Neumann vector all zeros.

  9. multi-device interpolation, Interpolator(mesh=...) on tetra_mesh(n):
     the mesh is every card (at most 8) where torch finds two or more,
     else ["cuda:0", "cuda:0"], two logical shards on one card.
     Replicated geometry on the fused route and on solver="pallas", and
     partitioned geometry (shard_geometry=True) on the unfused route,
     each through main_path (launches: one chunk per shard chunk of
     each class), its weights and Neumann vector within 1e-11 absolute
     of phase 5's, 5c's and 5b's, the same n_bad, the peak memory of
     each distinct card over its runs; one profiled run of each
     geometry mode (busy and idle share of each distinct card, host
     and device ms of the cross-part gathers and of the device-to-device
     merges); the geometry bytes each shard holds in both modes; IDW
     within 1e-13 and LS within 1e-11 (where |denom| > 1e-8) of phase
     8's weights in both modes;
 10. kernel 1's stage probe (tools/kernel_stages.py) on phase 4's chunks:
     the solve kernel's stage-cut instances (ops/gls_solve.py::
     gls_solve_stage) at both rounds, each cut's cumulative and stage ms,
     bound and share, beside the unfused route's kernels for the same
     stages on the same inputs; every other cut held to its plain
     version, gls_solve_reference(..., stop=...), on the same tensors
     (zero w and wn, each node's checksum within kernel_stages.CUT_TOL,
     the largest error of each cut in the JSON line); the "all" cut
     equal to gls_solve to the bit, the cumulative times rising with the
     cuts and the "all" cut within 3% of phase 4's kernel time; one
     {"kernel_stages": ...} JSON line;
 11. kernel 1's factorization probes (tools/factor_probes.py) on phase
     4's chunks, on the unfused route's float32 tensors there: the four
     kernels of csrc/factor_probes.cu (chol_factor, chol_trsm_gram after
     the elimination's factor and after tensor-core panels of three
     widths, chol_linv_tc at four and with a right factor, L2^-1 L1^-1
     as kernel 1's chol2, chol_trisolve_apply with its solves pivot by
     pivot and by blocks of 8 rows), each timed as phase 10 times a cut,
     beside its bound, the nearest library composition, phase 10's cuts
     it would replace and the unfused kernels; registers, spills, shared
     memory and blocks per SM; every instance also at kernel 1's shared
     memory request (its blocks an SM), chol_trisolve_apply also at
     applies = 0; the TPU probes' verdicts (trisolve: both sides at
     kernel 1's request) and the chol2 verdict on these times; every
     instance launched in the timed run, at both requests, and held to
     its plain version there (tools/factor_probes.py: TOL of its scale,
     or CHOL_RATIO times the plain version's own distance from float64);
     one {"factor_probes": ...} JSON line;
 12. kernel 1's Gram and Q probes on the tensor cores
     (tools/mxu_probes.py) on phase 4's chunks, on the unfused route's
     float32 tensors there (As, L1^-1, G1, and both laid out node-minor
     by node_transpose): the four kernels of csrc/mxu_probes.cu
     (node_transpose both ways; gram_tc on DMMA, 3xTF32 and bf16,
     node-major and node-minor; q_tc; gram_q_gram_tc in both layouts),
     each timed as phase 10 times a cut, beside its bound, the library
     call, phase 10's gram1, q and gram2 cuts and the unfused Gram
     kernels; registers, spills, shared memory and blocks per SM; the
     DMMA node-major Gram also at kernel 1's shared memory request (the
     gram1 verdict); then the node-minor Gram at r5_mxu_shapes.py's seven
     shapes on 16,384 synthetic nodes; the TPU probes' verdicts (mxu,
     precision, shapes); every instance, at both requests, launched in
     the timed run and held to its plain version (node_transpose bit for
     bit, the products within 1e-5 of the operands' magnitude product a
     node), with its distance from float64; one {"mxu_probes": ...} JSON
     line;
 13. kernel 1's input stream (tools/input_probes.py) on phase 4's chunks:
     the two kernels of csrc/input_probes.cu, input_sum (each node's
     kernel-1 inputs summed: the thirteen tensors as the route gathers
     them, a warp a node in persistent blocks with each node's spans by
     cp.async.bulk a node ahead, and read as kernel 1's prologue reads
     them; the same bytes packed once and read by 8-byte words a warp a
     node in persistent blocks, by 16-byte loads, by one cp.async.bulk,
     a warp a node and node-minor, S warps a 32-node group; the
     redesigned natural, packed and minor bodies and the prologue also
     at kernel 1's shared memory) and overlap_probe
     (the packed record summed, then a trivial body, the TPU probe's
     dummy work seeded from an argument or from the sum, or the work
     alone, one node a block or in persistent blocks that copy the next
     node's record by cp.async.bulk; at its own shared memory and at
     kernel 1's; at 60 rounds and at rounds calibrated on the card), each
     timed as phase 10 times a cut with 256 MB written before each
     launch (no input stays in L2), beside its bound, GB/s and HBM share,
     the library call, kernel 1's floor cut timed the same way and phase
     10's; registers, spills, shared memory and blocks per SM; the TPU
     probes' layout and overlap verdicts, and the floor verdict (does
     kernel 1's floor need a pack step); every instance launched in the
     timed run and held to its plain version (the sums within 1e-12 of
     the record's magnitudes a node, the dummy work within 1e-5 of its
     own); one {"input_probes": ...} JSON line.

Each phase prints its seconds.  Any failing phase raises (non-zero
exit).  The last four lines are the mesh JSON line (phase 9), the card,
the kernels JSON line (kernel 1's entry also holds its single-round
instance's rows and times; phase 11's kernels have an entry for each
tools/ site they replace, six in all, phase 12's eight and phase 13's
five) and
{"ok": true, "device": {...}}.

Run: python3 chip_smoke.py     (options: --n N, the tet mesh size;
--hexa N, phase 8's hexa mesh; --n-round1 N, phase 7's tet mesh)
"""
import argparse
import contextlib
import glob
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

# bench.py's problem through the port, the card's bound (H100 peaks),
# kernel 1's stage probe, its factorization probes, its tensor-core Gram
# and Q probes and its input-stream probes
from ninpol_tpu_torch.tools import (factor_probes, input_probes,
                                    kernel_stages, mxu_probes, site_of)
from ninpol_tpu_torch.tools.problem import PEAK_FP64, bound, build_problem

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
# phase 9: a mesh's weights against one device's (tests/test_sharding.py)
MESH_TOL = 1e-11
# phase 10: how far a later stage cut may time below the one before, and
# the "all" cut from phase 4's kernel time (relative; and in ms, for the
# smallest cuts)
STAGE_NOISE = 0.03
STAGE_NOISE_MS = 0.002
# the sweep counts tried, in turn, until every node of a chunk
# converges: phase 4f's for the solve kernel's single-round instance,
# phase 5d's (refinement sweeps) for the "refined" solver
ROUND1_CHECK_SWEEPS = (10, 20, 40, 80, 160, 320, 640)
REFINED_CHECK_SWEEPS = (3, 4, 8, 16)
SOLVE_KERNELS = ("gram_f32", "chol_linv_f32", "round2_gram_f32",
                 "prec_apply_f32")
# the port's profiler ranges (the mesh's and the GLS chunk steps'): their
# device-side spans cover kernels already counted, so no busy time sums
# them
RANGE_PREFIX = "ninpol_tpu_torch."
# kernel launches per solve chunk of each route
PER_CHUNK = {"fused": {"gls_solve": 1},
             "shard_geometry": {"gram_f32": 1, "chol_linv_f32": 2,
                                "round2_gram_f32": 1, "prec_apply_f32": 4},
             "pallas": {"qr_r": 1, "sne_solve": 2},
             # torch ops only: ninpol_tpu has no Pallas kernel for it
             "refined": {}}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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


def sync_all():
    """Wait for every card (a mesh may span several)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def route_chunks(classes, mesh=None):
    """Solve chunks a run of the route's main path: each class's nodes
    split over the mesh's shards (one shard without a mesh), each shard's
    part cut at the class's chunk."""
    from ninpol_tpu_torch.parallel import schedule

    shards = 1 if mesh is None else mesh.size
    return sum(len(schedule(len(c["nodes"]), shards, c["chunk"]))
               for c in classes)


def hold_solve(inp, sweeps, rounds):
    """The solve kernel's ``rounds`` instance and its plain version on one
    chunk at ``sweeps``: w and wn to <= TOL_KERNEL scaled on the nodes
    both call converged (rnorm <= RNORM_TOL), and the same rnorm >
    RNORM_TOL sets.  Returns the comparison's numbers."""
    from ninpol_tpu_torch.ops import gls_solve as gs

    kw = dict(sweeps=sweeps, rounds=rounds)
    wk, wnk, rk = gs.gls_solve(**inp, **kw)
    wp, wnp, rp = gs.gls_solve_reference(**inp, **kw)
    torch.cuda.synchronize()
    conv = (rk <= RNORM_TOL) & (rp <= RNORM_TOL)
    scale = max(float(wp.abs().max()), 1.0)
    err = max(float((wk - wp)[conv].abs().max()),
              float((wnk - wnp)[conv].abs().max())) if conv.any() else 0.0
    out = {"sweeps": sweeps, "max_abs_err": err,
           "max_scaled_err": err / scale, "n_converged_both": int(conv.sum()),
           "n_unconverged_kernel": int((rk > RNORM_TOL).sum()),
           "n_unconverged_plain": int((rp > RNORM_TOL).sum()),
           "same_fallback_set": bool(torch.equal(rk > RNORM_TOL,
                                                 rp > RNORM_TOL))}
    check(err / scale <= TOL_KERNEL,
          f"kernel vs plain: scaled error {err / scale:.3e} > {TOL_KERNEL} "
          f"at rounds={rounds}: {out}")
    check(out["same_fallback_set"], f"kernel and plain rnorm > {RNORM_TOL} "
                                    f"sets differ at rounds={rounds}: {out}")
    return out


def round1_converged(inp, B):
    """Phase 4f: the route's 5 sweeps leave a (24, 36) or (12, 24) chunk
    of tetra_mesh(68) unconverged at rounds = 1, so no weight would be
    compared there, and part way to convergence the kernel's and the
    plain version's rnorm straddle RNORM_TOL on some nodes.  So the
    first of ROUND1_CHECK_SWEEPS at which the kernel converges every
    node of the chunk, held to the plain version there by phase 4's rule;
    fails if none does."""
    from ninpol_tpu_torch.ops import gls_solve as gs

    shares = {}
    for sweeps in ROUND1_CHECK_SWEEPS:
        _, _, rk = gs.gls_solve(**inp, sweeps=sweeps, rounds=1)
        shares[sweeps] = float((rk <= RNORM_TOL).sum()) / B
        if shares[sweeps] == 1.0:
            break
    check(shares[sweeps] == 1.0, f"rounds=1: the kernel leaves nodes "
                                 f"unconverged at every sweep count tried: "
                                 f"{shares}")
    out = hold_solve(inp, sweeps, rounds=1)
    check(out["n_converged_both"] == B,
          f"rounds=1: the plain version leaves nodes unconverged: {out}")
    return dict(out, converged_share_by_sweeps=shares)


def kernel_vs_plain(interp, chunks, rounds=2):
    """Phase 4 (4f with ``rounds`` = 1): one chunk of every class
    (``chunks``: kernel_stages.chunk_inputs) through the kernel's
    ``rounds`` instance and through the plain version, on the card, with
    the route's sweeps for those rounds; at rounds = 1 also at the sweeps
    where most of the chunk converges (``round1_converged``).  Times are
    the route's sweeps': the kernel's the least of kernel_stages.REPS
    single launches, each queued behind device work (kernel_stages.best_ms,
    as phase 10 times the cuts it is held to), so that a host stall between two launches, which
    leaves the card idle, does not enter it; the plain version's the
    mean of 2 runs."""
    from ninpol_tpu_torch.ops import gls_solve as gs

    sweeps = kernel_stages.route_sweeps(interp.gls.n_refine, rounds)
    classes = [c for c, _, _ in chunks]
    rows = []
    for c, inp, n_elem in chunks:
        B = inp["dk"].shape[0]
        kw = dict(sweeps=sweeps, rounds=rounds)
        held = hold_solve(inp, sweeps, rounds)
        ms = kernel_stages.best_ms(lambda: gs.gls_solve(**inp, **kw))
        plain_ms = cuda_ms(lambda: gs.gls_solve_reference(**inp, **kw), 2)
        # per round an m n^2/2-FMA Gram product, a clamped Cholesky
        # factorization and a triangular inverse (n^3/3 FLOP each), and
        # between the rounds Q (m n^2/2 FMAs); the float64 sweeps are
        # O(m n) per node and left out
        E, F = c["E"], c["F"]
        m, n = E + (4 if c["with_neumann"] else 3) * F, 3 * E + 1
        nbytes = (sum(x.nbytes for x in inp.values() if x is not None)
                  + B * (E + 2) * 8)
        flops = (3 * m * n * n + 4 * n ** 3 / 3 if rounds == 2
                 else m * n * n + 2 * n ** 3 / 3)
        bound_ms, bound_by = bound(B * flops, nbytes)
        occ = gs.occupancy(E, F, c["with_neumann"], rounds)
        row = {"rounds": rounds, "E": E, "F": F,
               "with_neumann": c["with_neumann"],
               "nodes_in_class": len(c["nodes"]), "chunk": B,
               **{k: occ[k] for k in ("smem_bytes", "blocks_per_sm",
                                      "registers", "local_bytes")}, **held,
               "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None}
        if rounds == 1:
            row["converged"] = round1_converged(inp, B)
            row["max_abs_err"] = max(row["max_abs_err"],
                                     row["converged"]["max_abs_err"])
        if c is max(classes, key=lambda c: len(c["nodes"])):
            row["library_ms"] = lstsq_ms(inp, n_elem)
        print(f"# class rounds={rounds} " + json.dumps(row), flush=True)
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
        del got, ref

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
        # triangular, a Gram matrix is symmetric.  prec_apply's bytes count
        # Lc's triangle, all its kernel reads; the Gram products write the
        # full symmetric G that their contract returns.
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
                2 * B * n * (n + 1),
                B * n * (n + 1) // 2 * 4 + 2 * v.nbytes)}
        # each two-body kernel's inputs, and further inputs held to the
        # result (prec_apply's random vector)
        body_args = {"gram_f32": ((As,), ()),
                     "round2_gram_f32": ((As, Li1), ()),
                     "prec_apply_f32": ((Lc, v),
                                        (("random_v", (Lc, v_rand)),))}
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
            if name in body_args:
                kernel_bodies(name, row, *body_args[name], magnitude)
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
                # L^-1 (or of L^-1 Li1, triangular too); of G (symmetric)
                # and P (lower triangular) the function needs the lower
                # triangle
                B * 2 * n ** 3 / 3,
                (1 if P is None else 2) * B * n * (n + 1) // 2 * 4
                + out_bytes)
            print("# chol_linv_f32 " + json.dumps(row), flush=True)
            check(torch.equal(fk, fp), f"chol_linv kernel and plain version "
                                       f"flag different pivots: {row}")
            check(bk <= CHOL_BACKWARD_RATIO * bp,
                  f"chol_linv backward error {bk:.3e} > "
                  f"{CHOL_BACKWARD_RATIO} x plain {bp:.3e}: {row}")
            rows["chol_linv_f32"].append(row)
        del pc, As, G1, Li1, G2, Lc, v, v_rand, prec_random, body_args
    return classes, rows


# the bodies of the kernels that have two, by path=: the library's
# <name>_path(n) gives the one a width takes; body 2 has a width limit
BODIES = {"gram_f32": ((2, "register"), (1, "shared")),
          "round2_gram_f32": ((2, "register"), (1, "shared")),
          "prec_apply_f32": ((2, "warp"), (1, "shared"))}


def kernel_bodies(name, row, args, extra_inputs, magnitude):
    """Phase 4c for a kernel with two bodies: the body its class takes,
    and each body's error on ``args`` (held to TOL_F32 of the magnitude
    product, as the default), its error on each of ``extra_inputs`` (held
    to TOL_F32 of the result), time and launch on an SM.  The Gram
    products' bodies sum each entry in one order: their results must be
    equal to the bit."""
    from ninpol_tpu_torch.ops import cholqr as cq

    kernel, plain = getattr(cq, name), getattr(cq, f"{name}_reference")
    n = args[0].shape[-1]
    row["path"] = getattr(cq.library.get(), f"{name}_path")(n)
    ref = plain(*args)
    mag = magnitude().reshape(ref.shape)
    outs = {}
    for p, label in BODIES[name]:
        if p == 2 and row["path"] != 2:    # no body 2 at this width
            continue
        outs[p] = kernel(*args, path=p)
        err = scaled_err(outs[p], ref, mag)
        row[f"{label}_err_over_magnitude"] = err
        row[f"{label}_ms"] = cuda_ms(lambda: kernel(*args, path=p), 5)
        row[f"{label}_occupancy"] = cq.occupancy(name, n, p)
        check(err <= TOL_F32, f"{name} {label} body: error {err:.3e} of "
                              f"the magnitude product > {TOL_F32}: {row}")
        for key, inputs in extra_inputs:
            r = plain(*inputs)
            e = scaled_err(kernel(*inputs, path=p), r, r)
            row[f"{label}_{key}_err_over_result"] = e
            check(e <= TOL_F32, f"{name} {label} body on {key}: error "
                                f"{e:.3e} of the result > {TOL_F32}: {row}")
    if name != "prec_apply_f32" and len(outs) == 2:
        row["bodies_equal"] = bool(torch.equal(outs[1], outs[2]))
        check(row["bodies_equal"], f"{name}: the register and shared "
                                   f"bodies differ: {row}")


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


def refined_vs_fused(interp, tp):
    """Phase 5d: the "refined" solver itself on the card, on up to 8192
    nodes of every class: its converged share at the route's n_refine
    sweeps (the route sends the rest to the exact fallback), then the
    first of REFINED_CHECK_SWEEPS at which it converges every node, where
    its weights must be within TOL_KERNEL scaled of the fused kernel's."""
    from ninpol_tpu_torch._methods.gls import gls_gather, gls_solve_refined
    from ninpol_tpu_torch.ops import gls_solve as gs

    dgrid = interp.device_grid
    classes, face_table, nflag = interp.gls.plan(
        dgrid, interp.cells_data, interp.points_data,
        interp.variable_to_index, "u", tp)
    rows = []
    for c in classes:
        nodes = torch.as_tensor(c["nodes"][:8192], device=dgrid.device)
        B = len(nodes)
        args = (dgrid, face_table, nflag, nodes, c["E"], c["F"],
                c["with_neumann"])
        inp, _ = gls_gather(*args, tau_guard="norm")
        wf, wnf, rf = gs.gls_solve(**gls_gather(*args)[0])
        shares = {}
        for n_refine in (interp.gls.n_refine,) + REFINED_CHECK_SWEEPS:
            w, wn, r = gls_solve_refined(**inp, n_refine=n_refine)
            shares[n_refine] = float((r <= RNORM_TOL).sum()) / B
            if n_refine != interp.gls.n_refine and shares[n_refine] == 1.0:
                break
        torch.cuda.synchronize()
        conv = (r <= RNORM_TOL) & (rf <= RNORM_TOL)
        scale = max(float(wf.abs().max()), 1.0)
        err = max(float((w - wf)[conv].abs().max()),
                  float((wn - wnf)[conv].abs().max())) / scale \
            if conv.any() else 0.0
        row = {"E": c["E"], "F": c["F"], "with_neumann": c["with_neumann"],
               "nodes": B, "converged_share_by_n_refine": shares,
               "n_refine_held": n_refine,
               "n_converged_both": int(conv.sum()),
               "max_scaled_err_vs_fused": err}
        print("# refined solver " + json.dumps(row), flush=True)
        check(int(conv.sum()) == B,
              f"refined: nodes left unconverged at every sweep count "
              f"tried, or by the fused kernel: {row}")
        check(err <= TOL_KERNEL, f"refined vs fused kernel: {row}")
        rows.append(row)
        del inp, w, wn, r, wf, wnf, rf
    return rows


def main_path(interp, tp, classes, label, max_bad=MAX_BAD, with_csr=True,
              route=None):
    """Phase 5 (5b, 5c, 5d; 9 on a mesh): the public entry points of one
    route (``route``, default ``label``: a key of PER_CHUNK), counting
    every kernel's launches and every plain version's calls: a warm-up, 3
    timed device_out runs and, ``with_csr``, interpolate().  More than
    ``max_bad`` nodes sent to the exact fallback fail it (None: any
    number)."""
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
    chunks = route_chunks(classes, interp.mesh)
    for w in wrappers.values():
        w.launches = 0
    try:
        t0 = time.perf_counter()
        W, NW = interp.prepare_interpolator("gls", "u", tp)
        warm_s = time.perf_counter() - t0
        times = []
        for _ in range(3):
            sync_all()
            t0 = time.perf_counter()
            wdev = interp.prepare_interpolator("gls", "u", tp,
                                               device_out=True)
            sync_all()
            times.append(time.perf_counter() - t0)
        n_bad = interp.gls.last_n_bad
        if with_csr:
            t0 = time.perf_counter()
            csr, _ = interp.interpolate("u", "gls")
            csr_s = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    runs = 5 if with_csr else 4     # warm-up, 3 timed[, interpolate]
    per_chunk = PER_CHUNK[route or label]
    want = {k: runs * chunks * per_chunk.get(k, 0) for k in wrappers}
    check(launches == want,
          f"{label}: kernel launches {launches} != {want} ({runs} runs x "
          f"{chunks} chunks): some class did not go through the kernels")
    check(not plain_calls, f"{label}: plain versions called on the main "
                           f"path: {sorted(set(plain_calls))}")
    # a wrong preconditioner only stops nodes converging, and the exact
    # fallback would then hide it behind right weights
    check(max_bad is None or n_bad <= max_bad,
          f"{label}: {n_bad} nodes fell back to the exact solve (limit "
          f"{max_bad})")
    check(torch.isfinite(wdev).all().item(), f"{label}: non-finite weights")
    check(tuple(wdev.shape) == (len(tp), W.shape[1] + 1),
          f"{label}: device_out shape {tuple(wdev.shape)}")
    host = wdev.cpu().numpy()
    gap = max(np.abs(host[:, :-1] - W).max(), np.abs(host[:, -1] - NW).max())
    check(gap <= 1e-12 * max(np.abs(W).max(), 1.0),
          f"{label}: device_out differs from host delivery by {gap:.3e}")
    t = min(times)
    stats = {"warmup_s": warm_s, "device_out_s": times, "best_s": t,
             "mnodes_per_s": len(tp) / t / 1e6, "n_bad": n_bad,
             "launches": launches, "chunks_per_run": chunks}
    if with_csr:
        check(csr.shape == (len(tp), interp.grid.n_elems),
              f"{label}: CSR shape")
        stats.update(interpolate_s=csr_s, csr_nnz=int(csr.nnz))
    print(f"# main path {label} " + json.dumps(stats), flush=True)
    return W, NW, stats


def profile_main_path(interp, tp, label, method="gls"):
    """One more device_out run under torch.profiler: device busy share
    and the kernels that take the device time (after the launch count
    was read, so these launches are not counted)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        interp.prepare_interpolator(method, "u", tp, device_out=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched, and a range's device-side span the
    # time of the kernels inside it
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith(RANGE_PREFIX)]
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    stats = {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
             "idle_share": 1.0 - busy_ms / (wall * 1e3),
             "top": [{"name": k[0][:80], "ms": k[1], "calls": k[2]}
                     for k in kernels[:16]]}
    print(f"# profile {label} " + json.dumps(stats), flush=True)
    return stats


def phase_run(interp, tp, device_out, label):
    """Phase 5e: one GLS prepare_interpolator with NINPOL_TPU_PHASES=1.
    Returns its result, its phase line as [(name, seconds)] and the wall
    seconds from a synchronized start to device completion."""
    prefix = "# gls phases: "
    err = io.StringIO()
    sync_all()
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, {"NINPOL_TPU_PHASES": "1"}), \
            contextlib.redirect_stderr(err):
        out = interp.prepare_interpolator("gls", "u", tp,
                                          device_out=device_out)
    sync_all()
    wall = time.perf_counter() - t0
    lines = err.getvalue().splitlines()
    rest = [ln for ln in lines if not ln.startswith(prefix)]
    if rest:
        print("\n".join(rest), file=sys.stderr, flush=True)
    lines = [ln for ln in lines if ln.startswith(prefix)]
    check(len(lines) == 1, f"5e {label}: {len(lines)} phase lines")
    phases = []
    for token in lines[0][len(prefix):].split(" "):
        name, t = token.rsplit("=", 1)
        check(re.fullmatch(r"\d+\.\d{3}s", t) is not None,
              f"5e {label}: phase token {token!r}")
        phases.append((name, float(t[:-1])))
    print(f"{lines[0]}  # {label}, wall to device completion "
          f"{wall:.4f}s", flush=True)
    return out, phases, wall


def trace_summary(events, chunks):
    """Phase 5e: the GLS trace the profile hook wrote (its events): the
    solve-kernel events, the ranges of solve_class (count, summed host
    ms, summed ms of their device-side spans), the kernels' and copies'
    busy ms, and the CUDA runtime calls' count and host ms by name."""
    from ninpol_tpu_torch._methods.gls import (
        EPILOGUE_RANGE, EXACT_RANGE, GATHER_RANGE, SOLVE_RANGE)

    ranges = {name: {"count": 0, "host_ms": 0.0, "device_ms": 0.0}
              for name in (GATHER_RANGE, SOLVE_RANGE, EPILOGUE_RANGE,
                           EXACT_RANGE)}
    busy = copy_ms = 0.0
    solve_kernels = n_kernels = n_copies = 0
    runtime = {}
    for e in events:
        cat, name, dur = e.get("cat"), e.get("name", ""), e.get("dur", 0)
        if cat == "user_annotation" and name in ranges:
            ranges[name]["count"] += 1
            ranges[name]["host_ms"] += dur / 1e3
        elif cat == "gpu_user_annotation" and name in ranges:
            ranges[name]["device_ms"] += dur / 1e3
        elif cat == "kernel":
            n_kernels += 1
            busy += dur / 1e3
            solve_kernels += "gls_solve_kernel" in name
        elif cat in ("gpu_memcpy", "gpu_memset"):
            n_copies += 1
            copy_ms += dur / 1e3
        elif cat == "cuda_runtime":
            r = runtime.setdefault(name, {"calls": 0, "host_ms": 0.0})
            r["calls"] += 1
            r["host_ms"] += dur / 1e3
    check(solve_kernels == chunks,
          f"5e: {solve_kernels} gls_solve_kernel events in the trace, "
          f"{chunks} chunks")
    for name in (GATHER_RANGE, SOLVE_RANGE, EPILOGUE_RANGE):
        check(ranges[name]["count"] == chunks,
              f"5e: range {name} {ranges[name]['count']} times in the "
              f"trace, {chunks} chunks")
    check(ranges[EXACT_RANGE]["count"] == 0, "5e: an exact range at n_bad 0")
    return {"gls_solve_kernel_events": solve_kernels,
            "kernel_events": n_kernels, "kernel_busy_ms": busy,
            "copy_events": n_copies, "copy_busy_ms": copy_ms,
            "ranges": ranges, "cuda_runtime": runtime}


def profiled_run(interp, tp, method, label):
    """Phase 5e: one device_out run with NINPOL_TPU_PROFILE set to a fresh
    temporary directory, which must then hold exactly one trace.  Returns
    the run's result, its wall seconds (to device completion) and the
    trace's events."""
    with tempfile.TemporaryDirectory() as d, \
            mock.patch.dict(os.environ, {"NINPOL_TPU_PROFILE": d}):
        sync_all()
        t0 = time.perf_counter()
        out = interp.prepare_interpolator(method, "u", tp, device_out=True)
        sync_all()
        wall = time.perf_counter() - t0
        files = glob.glob(os.path.join(d, "*.pt.trace.json"))
        check(len(files) == 1, f"5e {label}: {len(files)} trace files")
        size = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    print(f"# 5e {label}: one trace, {size} bytes, {len(events)} events, "
          f"wall to device completion {wall:.4f}s", flush=True)
    return out, wall, events


def tracing_phase(interp, unfused, tp, fused_w, unfused_w, chunks):
    """Phase 5e: the port's two tracing hooks on the full main path (the
    module docstring).  ``fused_w`` and ``unfused_w`` are phases 5's and
    5b's hooks-off (W, NW); ``chunks`` the route's chunks a run."""
    ref = interp.prepare_interpolator("gls", "u", tp, device_out=True)
    host = ref.cpu().numpy()
    check(np.array_equal(host[:, :-1], fused_w[0])
          and np.array_equal(host[:, -1], fused_w[1]),
          "5e: the hooks-off device_out run differs from phase 5's")
    base = ["face_cache", "bucket_plan", "dispatch", "n_bad_sync(n_bad=0)"]
    stats = {}
    for label, ip, device_out, want_w in (
            ("fused device_out", interp, True, fused_w),
            ("fused host", interp, False, fused_w),
            ("unfused device_out", unfused, True, unfused_w)):
        runs = []
        for _ in range(3):
            out, phases, wall = phase_run(ip, tp, device_out, label)
            names = [n for n, _ in phases]
            times = [t for _, t in phases]
            want = base + ([] if device_out else ["host_write"])
            check(names == want, f"5e {label}: phases {names}, not {want}")
            check(times == sorted(times), f"5e {label}: times fall {phases}")
            check(ip.gls.last_n_bad == 0,
                  f"5e {label}: last_n_bad {ip.gls.last_n_bad}")
            if device_out:
                if ip is interp:
                    check(torch.equal(out, ref),
                          f"5e {label}: differs from the hooks-off run")
                out = out.cpu().numpy()
                out = out[:, :-1], out[:, -1]
            check(np.array_equal(out[0], want_w[0])
                  and np.array_equal(out[1], want_w[1]),
                  f"5e {label}: differs from the hooks-off result")
            runs.append({"wall_s": wall, **dict(phases)})
        stats[label] = runs
    print("# tracing phases " + json.dumps(stats), flush=True)

    out, wall, events = profiled_run(interp, tp, "gls", "gls profile")
    check(torch.equal(out, ref),
          "5e gls profile: differs from the hooks-off run")
    summary = trace_summary(events, chunks)
    summary["wall_ms"] = wall * 1e3
    print("# tracing profile " + json.dumps(summary), flush=True)

    ref_idw = interp.prepare_interpolator("idw", "u", tp, device_out=True)
    out, _, _ = profiled_run(interp, tp, "idw", "idw profile")
    # the bits: NaN equals no float
    check(torch.equal(out.view(torch.int64), ref_idw.view(torch.int64)),
          "5e idw profile: differs from the hooks-off run")


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


def one_round_route(n):
    """Phase 7: the fused route at precond_rounds = 1 (the kernel's
    single-round instance, two more sweeps, the exact fallback) on
    tetra_mesh(n), against the same route at rounds = 2: weights within
    1e-10 scaled.  ninpol_tpu measured an exact-fallback storm at
    rounds = 1 on a 1M-cell tet mesh; n_bad is printed, not bounded."""
    from ninpol_tpu_torch.ops import gls_solve as gs

    interp, _ = build_problem(n)
    tp = np.arange(interp.grid.n_points)
    W2, NW2 = interp.prepare_interpolator("gls", "u", tp)
    bad2 = interp.gls.last_n_bad
    interp.gls.precond_rounds = 1
    classes, _, _ = interp.gls.plan(
        interp.device_grid, interp.cells_data, interp.points_data,
        interp.variable_to_index, "u", tp)
    chunks = sum(-(-len(c["nodes"]) // c["chunk"]) for c in classes)
    gs.gls_solve.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    W1, NW1 = interp.prepare_interpolator("gls", "u", tp)
    seconds = time.perf_counter() - t0
    launches = gs.gls_solve.launches
    interp.gls.precond_rounds = 2
    scale = max(np.abs(W2).max(), 1.0)
    gap = max(np.abs(W1 - W2).max(), np.abs(NW1 - NW2).max()) / scale
    stats = {"cells": interp.grid.n_elems, "points": len(tp),
             "n_bad_rounds1": interp.gls.last_n_bad, "n_bad_rounds2": bad2,
             "seconds_rounds1": seconds, "launches": launches,
             "chunks": chunks, "max_scaled_diff": float(gap)}
    print("# rounds=1 route " + json.dumps(stats), flush=True)
    check(launches == chunks, f"rounds=1: {launches} solve-kernel launches "
                              f"for {chunks} chunks")
    check(gap <= TOL_ORACLE, f"rounds=1 weights differ from rounds=2 by "
                             f"{gap:.3e} scaled")
    return stats


def ls_denominators(dgrid, tp, chunk=262144):
    """LS's denominator over the cell count at the nodes ``tp`` (1 where
    the system is degenerate), on ``dgrid``'s device: ls_oracle's
    normalisation, whose |denom| > 1e-8 picks the nodes held to a bound
    (test_methods.py:50-57)."""
    from ninpol_tpu_torch._methods.idw import simple_gather
    from ninpol_tpu_torch._methods.ls import ls_math

    E = int(dgrid.esup_cnt_h[tp].max())
    out = []
    for lo in range(0, len(tp), chunk):
        nodes = torch.as_tensor(tp[lo:lo + chunk], device=dgrid.device)
        xv, xc, cv, n_elem = simple_gather(dgrid, nodes, E)
        _, denom, degen = ls_math(xv, xc, cv, n_elem)
        norm = denom / torch.clamp_min(n_elem, 1).to(denom.dtype)
        out.append(torch.where(degen, 1.0, norm).cpu().numpy())
    return np.concatenate(out)


def simple_methods(interp, label):
    """Phase 8: IDW and LS through the public entry points on one mesh: a
    warm-up, 3 timed device_out runs, interpolate() to CSR and a
    profiled run each; the card's weights held on every node to the
    port's own run on the CPU (IDW <= 1e-13 absolute, LS <= 1e-11 where
    |denom| > 1e-8), and on 2048 sampled nodes to idw_oracle /
    ls_oracle (same bounds); the Neumann vector all zeros.  Returns the
    stats, and each method's weights with the mask of nodes held to a
    bound."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from utils.oracle import idw_oracle, ls_oracle
    from ninpol_tpu_torch._methods.device_grid import DeviceGrid

    grid = interp.grid
    tp = np.arange(grid.n_points)
    v2i = interp.variable_to_index
    nflag = interp.points_data[v2i["points"]["neumann_flag_u"]].astype(int)
    t0 = time.perf_counter()
    cpu_grid = DeviceGrid(grid, device="cpu")
    cpu_grid_s = time.perf_counter() - t0
    sample = np.sort(np.random.default_rng(2).choice(
        tp, min(2048, len(tp)), replace=False))
    out, weights = {}, {}
    for method, tol in (("idw", 1e-13), ("ls", 1e-11)):
        t0 = time.perf_counter()
        W, NW = interp.prepare_interpolator(method, "u", tp)
        warm_s = time.perf_counter() - t0
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wdev = interp.prepare_interpolator(method, "u", tp,
                                               device_out=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        csr, neu = interp.interpolate("u", method)
        csr_s = time.perf_counter() - t0
        prof = profile_main_path(interp, tp, f"{method} {label}", method)

        # the port's own run of the method on the CPU, same grid and data
        t0 = time.perf_counter()
        Wc, _ = interp.supported_methods[method](
            cpu_grid, interp.cells_data, interp.points_data,
            interp.faces_data, v2i, "u", tp, np.zeros_like(W),
            np.zeros_like(NW))
        cpu_s = time.perf_counter() - t0
        host = wdev.cpu().numpy()
        with np.errstate(all="ignore"):
            if method == "ls":
                held = np.abs(ls_denominators(cpu_grid, tp)) > 1e-8
                Wo, den = ls_oracle(grid, sample, nflag, return_denom=True)
                held_o = np.abs(den) > 1e-8
            else:
                held = np.ones(len(tp), dtype=bool)
                Wo = idw_oracle(grid, sample, nflag)
                held_o = np.ones(len(sample), dtype=bool)
            cpu_err = float(np.abs(W - Wc)[held].max())
            k = min(W.shape[1], Wo.shape[1])
            oracle_err = float(np.abs(W[sample][:, :k] - Wo[:, :k])[
                held_o].max())
        best = min(times)
        stats = {"mesh": label, "points": len(tp),
                 "cells": grid.n_elems, "warmup_s": warm_s,
                 "device_out_s": times, "best_s": best,
                 "mnodes_per_s": len(tp) / best / 1e6,
                 "interpolate_s": csr_s, "csr_nnz": int(csr.nnz),
                 "cpu_run_s": cpu_s, "cpu_grid_s": cpu_grid_s,
                 "nodes_held": int(held.sum()),
                 "max_abs_err_vs_cpu": cpu_err,
                 "oracle_sampled": len(sample),
                 "oracle_held": int(held_o.sum()),
                 "max_abs_err_vs_oracle": oracle_err,
                 "device_busy_ms": prof["device_busy_ms"],
                 "idle_share": prof["idle_share"]}
        print(f"# {method} {label} " + json.dumps(stats), flush=True)
        check(tuple(wdev.shape) == (len(tp), W.shape[1] + 1),
              f"{method} {label}: device_out shape {tuple(wdev.shape)}")
        # LS is 0/0 where its denominator vanishes, in the oracle too
        check(np.array_equal(host[:, :-1], W, equal_nan=True),
              f"{method} {label}: device_out differs from host delivery")
        check(not host[:, -1].any() and not NW.any() and not neu.any(),
              f"{method} {label}: a Neumann weight is not zero")
        check(np.isfinite(W[held]).all(), f"{method} {label}: non-finite "
                                          f"weights")
        check(csr.shape == (len(tp), grid.n_elems),
              f"{method} {label}: CSR shape")
        check(held.sum() > len(tp) // 2 and held_o.sum() > len(sample) // 2,
              f"{method} {label}: too few nodes held to a bound")
        check(cpu_err <= tol, f"{method} {label}: card vs CPU {cpu_err:.3e} "
                              f"> {tol}")
        check(oracle_err <= tol, f"{method} {label}: card vs oracle "
                                 f"{oracle_err:.3e} > {tol}")
        out[method] = stats
        weights[method] = (W, held)
        del NW, Wc, wdev, host, csr
    return out, weights


def mesh_devices():
    """Phase 9's mesh: every card (at most 8) where torch finds two or
    more, else two logical shards on cuda:0."""
    n = torch.cuda.device_count()
    return ([f"cuda:{i}" for i in range(min(n, 8))] if n >= 2
            else ["cuda:0", "cuda:0"])


def mesh_profile(interp, tp, label):
    """One device_out GLS run on a mesh under torch.profiler: device busy
    ms and idle share of each distinct card (the union of its kernel and
    copy intervals), and the host and device ms of the cross-part gathers
    and of the device-to-device merges (their profiler ranges)."""
    from torch.profiler import ProfilerActivity, profile
    from ninpol_tpu_torch.parallel.sharding import GATHER_RANGE, MERGE_RANGE

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync_all()
        t0 = time.perf_counter()
        interp.prepare_interpolator("gls", "u", tp, device_out=True)
        sync_all()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    ranges = {GATHER_RANGE: [0, 0.0, 0.0], MERGE_RANGE: [0, 0.0, 0.0]}
    spans = {}
    for e in prof.events():
        if e.name.startswith(RANGE_PREFIX):
            if e.name in ranges and e.device_type != cuda:
                r = ranges[e.name]
                r[0] += 1
                r[1] += e.time_range.elapsed_us() / 1e3
                r[2] += e.device_time_total / 1e3
            continue
        if e.device_type == cuda:
            spans.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
    cards = {}
    for dev, iv in sorted(spans.items()):
        busy, end = 0.0, None
        for a, b in sorted(iv):
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        cards[f"cuda:{dev}"] = {"busy_ms": busy / 1e3,
                                "idle_share": 1.0 - busy / 1e3 / wall_ms,
                                "events": len(iv)}
    stats = {"wall_ms": wall_ms, "cards": cards,
             **{f"{key}_{name}": ranges[rng][i]
                for key, rng in (("gather", GATHER_RANGE),
                                 ("merge", MERGE_RANGE))
                for i, name in enumerate(("calls", "host_ms", "device_ms"))}}
    print(f"# profile {label} " + json.dumps(stats), flush=True)
    check(cards, f"{label}: the profile shows no device event")
    return stats


def mesh_run(interp, tp, classes, label, route, ref, mesh, profiled=False):
    """One GLS route of phase 9 through ``main_path`` on a mesh (launch
    counts per shard chunk, n_bad, device_out against host delivery),
    its weights and Neumann vector within 1e-11 absolute of the
    single-device ``ref`` = (W, NW, stats), the same n_bad, the peak
    memory of each distinct card over its runs and, ``profiled``, one
    profiled run."""
    for d in mesh.distinct:
        torch.cuda.reset_peak_memory_stats(d)
    W, NW, stats = main_path(interp, tp, classes, label, route=route)
    stats["peak_bytes"] = {str(d): torch.cuda.max_memory_allocated(d)
                           for d in mesh.distinct}
    W1, NW1, stats1 = ref
    gap = float(max(np.abs(W - W1).max(), np.abs(NW - NW1).max()))
    stats.update(max_abs_diff_vs_single=gap,
                 single_best_s=stats1["best_s"],
                 over_single=stats["best_s"] / stats1["best_s"])
    print(f"# {label} vs single device " + json.dumps(
        {k: stats[k] for k in ("max_abs_diff_vs_single", "best_s",
                               "single_best_s", "over_single", "n_bad",
                               "peak_bytes")}), flush=True)
    check(gap <= MESH_TOL, f"{label}: {gap:.3e} from the single-device "
                           f"weights (limit {MESH_TOL})")
    check(stats["n_bad"] == stats1["n_bad"],
          f"{label}: n_bad {stats['n_bad']} != single-device "
          f"{stats1['n_bad']}")
    if profiled:
        stats["profile"] = mesh_profile(interp, tp, label)
    return stats


def mesh_simple(interp, tp, label, ref):
    """IDW and LS on a mesh: one warm-up and one timed device_out run
    each, within 1e-13 (IDW, every node) and 1e-11 (LS, where |denom| >
    1e-8) of phase 8's single-device weights ``ref[method]`` = (W,
    held)."""
    out = {}
    for method, tol in (("idw", 1e-13), ("ls", 1e-11)):
        interp.prepare_interpolator(method, "u", tp, device_out=True)
        sync_all()
        t0 = time.perf_counter()
        wdev = interp.prepare_interpolator(method, "u", tp, device_out=True)
        sync_all()
        secs = time.perf_counter() - t0
        W1, held = ref[method]
        host = wdev.cpu().numpy()
        with np.errstate(invalid="ignore"):
            err = float(np.abs(host[:, :-1] - W1)[held].max())
        out[method] = {"device_out_s": secs, "max_abs_diff_vs_single": err,
                       "nodes_held": int(held.sum())}
        check(err <= tol, f"{method} {label}: {err:.3e} from the "
                          f"single-device weights (limit {tol})")
        check(not host[:, -1].any(), f"{method} {label}: a Neumann weight "
                                     f"is not zero")
    print(f"# idw/ls {label} " + json.dumps(out), flush=True)
    return out


def mesh_phase(n, ref):
    """Phase 9: multi-device interpolation (Interpolator(mesh=...)) on
    tetra_mesh(n), replicated and partitioned geometry, against the
    single-device results of phases 5, 5b, 5c and 8 (``ref``)."""
    from ninpol_tpu_torch.parallel import Mesh

    mesh = Mesh(mesh_devices())
    info = {"devices": [str(d) for d in mesh.devices],
            "distinct_cards": len(mesh.distinct),
            "names": [torch.cuda.get_device_name(d) for d in mesh.distinct]}
    print("# mesh devices " + json.dumps(info), flush=True)
    out = {"mesh": info}

    rep, _ = build_problem(n, mesh=mesh)
    tp = np.arange(rep.grid.n_points)
    dg = rep.device_grid
    classes, face_table, nflag = rep.gls.plan(
        dg, rep.cells_data, rep.points_data, rep.variable_to_index, "u", tp)
    out["chunks_per_run"] = route_chunks(classes, mesh)
    out["replicated_geometry_bytes"] = dg.geometry_bytes(
        (face_table, nflag))
    out["replicated_fused"] = mesh_run(rep, tp, classes, "mesh replicated "
                                       "fused", "fused", ref["fused"], mesh,
                                       profiled=True)
    rep.gls.solver = "pallas"
    out["replicated_pallas"] = mesh_run(rep, tp, classes, "mesh replicated "
                                        "pallas", "pallas", ref["pallas"],
                                        mesh)
    rep.gls.solver = "auto"
    out["replicated_idw_ls"] = mesh_simple(rep, tp, "mesh replicated", ref)
    del rep, dg, face_table, nflag

    part, _ = build_problem(n, shard_geometry=True, mesh=mesh)
    dg = part.device_grid
    _, face_table, nflag = part.gls.plan(
        dg, part.cells_data, part.points_data, part.variable_to_index, "u",
        tp)
    out["partitioned_geometry_bytes"] = dg.geometry_bytes(
        (face_table, nflag))
    out["partitioned_unfused"] = mesh_run(
        part, tp, classes, "mesh partitioned unfused", "shard_geometry",
        ref["shard_geometry"], mesh, profiled=True)
    out["partitioned_idw_ls"] = mesh_simple(part, tp, "mesh partitioned",
                                            ref)
    del part, dg, face_table, nflag
    print("# mesh geometry bytes " + json.dumps(
        {k: out[k] for k in ("replicated_geometry_bytes",
                             "partitioned_geometry_bytes")}), flush=True)
    return out


def stage_phase(chunks, rows, n_refine):
    """Phase 10: kernel 1's stage probe (tools/kernel_stages.py) on phase
    4's chunks, each cut held to its plain version (the probe's
    cut_errors, within kernel_stages.CUT_TOL) and to the production
    kernel: the "all" cut equals gls_solve to the bit at both rounds, the
    cumulative times rise with the cuts (within STAGE_NOISE), and the
    "all" cut's time is within STAGE_NOISE of phase 4's (``rows``) for
    its class."""
    from ninpol_tpu_torch.ops import gls_solve as gs

    ks = kernel_stages
    chunks = [(c, {k: None if v is None else v.cuda()
                   for k, v in inp.items()}, n_elem)
              for c, inp, n_elem in chunks]
    gs.gls_solve_stage.launches = 0
    for c, inp, _ in chunks:
        for rounds in (2, 1):
            kw = dict(sweeps=ks.route_sweeps(n_refine, rounds),
                      rounds=rounds)
            cut, prod = gs.gls_solve_stage("all", **inp, **kw), \
                gs.gls_solve(**inp, **kw)
            check(all(torch.equal(a, b) for a, b in zip(cut, prod)),
                  f"stage cut 'all' differs from gls_solve at rounds="
                  f"{rounds}, class ({c['E']}, {c['F']})")
    table = ks.probe(chunks, n_refine)
    ks.report(table)
    checks = []
    for row in table:
        label = f"({row['E']}, {row['F']})"
        for rounds, r in row["rounds"].items():
            ms = [cut["ms"] for cut in r["cuts"]]
            for a, b, cut in zip(ms, ms[1:], r["cuts"][1:]):
                checks.append((
                    b >= a - max(STAGE_NOISE * a, STAGE_NOISE_MS),
                    f"{label} rounds={rounds}: cut {cut['stop']} "
                    f"{b:.4f} ms < the cut before, {a:.4f} ms"))
        whole = row["rounds"]["2"]["cuts"][-1]["ms"]
        phase4 = [r["ms"] for r in rows if (r["E"], r["F"], r[
            "with_neumann"]) == (row["E"], row["F"], row["with_neumann"])]
        row["phase4_ms"] = phase4[0]
        checks.append((abs(whole - phase4[0]) <= STAGE_NOISE * phase4[0],
                       f"{label}: the 'all' cut takes {whole:.4f} ms, "
                       f"phase 4's kernel {phase4[0]:.4f} ms"))
    print(json.dumps({"kernel_stages": {
        "card": card_line(), "reps": ks.REPS,
        "launches": gs.gls_solve_stage.launches, "classes": table}}),
        flush=True)
    checks += [(False, msg) for msg in ks.failed_cuts(table)]
    for ok, msg in checks:
        check(ok, msg)
    return table


def factor_phase(chunks, stage_table):
    """Phase 11: kernel 1's factorization probes (tools/factor_probes.py)
    on phase 4's chunks, beside phase 10's cuts (``stage_table``): the
    timed run, with every probe kernel's launch counts set to 0 just
    before it and read just after (each instance must have launched),
    then each instance held to its plain version.  Returns (table,
    launches), launches by instance."""
    fp = factor_probes
    chunks = [(c, {k: None if v is None else v.cuda()
                   for k, v in inp.items()}, n_elem)
              for c, inp, n_elem in chunks]
    table, launches = fp.probe(
        chunks, [row["rounds"]["2"]["cuts"] for row in stage_table])
    del chunks
    fp.report(table)
    print(json.dumps({"factor_probes": {
        "card": card_line(), "reps": kernel_stages.REPS,
        "launches": launches, "classes": table}}), flush=True)
    for msg in fp.failed(table):
        check(False, msg)
    for name, count in launches.items():
        check(count > 0, f"phase 11: {name} was not launched in the timed "
                         f"run: {launches}")
    for msg in fp.unlaunched_k1(table):
        check(False, f"phase 11: {msg}")
    out_max = max(r["out_max"] for row in table
                  for r in row["kernels"].values())
    print(f"# phase 11: largest held output {out_max:.3e}, "
          f"{np.log10(np.finfo(np.float32).max / out_max):.1f} decades "
          f"below float32's largest", flush=True)
    return table, launches


def entry(name, source, replaces, launches, rows, top,
          tpu_file="pallas_chol.py"):
    """A kernel's entry of the kernels JSON line: ``replaces`` a line of
    ninpol_tpu/ops/<tpu_file>, or a site's path; its numbers ``top``'s,
    the timed class's row, beside every row of ``rows``."""
    return {"name": name, "route": "cuda",
            "source": f"ninpol_tpu_torch/csrc/{source}",
            "replaces": replaces if isinstance(replaces, str)
            else f"ninpol_tpu/ops/{tpu_file}:{replaces}",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")},
            "timed_class": {k: top[k] for k in (
                "E", "F", "with_neumann", "chunk")},
            "classes": rows}


def probe_entries(tool, source, table, launches):
    """The entries of a probe phase (``tool``: tools/factor_probes.py,
    tools/mxu_probes.py or tools/input_probes.py), one for each tools/ site
    its kernels replace (``tool.answer``): the site's fastest instance's
    numbers on the largest class's chunk (named in "instance"), every
    instance of the site in every class in "classes"; launches are the
    site's instances' in the phase's timed run.  max_abs_err is absolute, as in every
    entry; "max_err" is each node's error over its scale, the one held to
    tolerance."""
    top = max(table, key=lambda r: r["chunk"])
    sites = {}
    for kernel, kw in tool.CONFIGS:
        sites.setdefault(tool.answer(kernel, kw), []).append(
            tool.label(kernel, kw))
    out = []
    for name, labels in sites.items():
        rows = [dict(row["kernels"][label], E=row["E"], F=row["F"],
                     instance=label, with_neumann=row["with_neumann"],
                     chunk=row["chunk"])
                for row in table for label in labels]
        fastest = min(labels, key=lambda label: top["kernels"][label]["ms"])
        e = entry(name, source, site_of(name),
                  sum(launches[label] for label in labels), rows,
                  dict(top["kernels"][fastest], **{
                      k: top[k] for k in ("E", "F", "with_neumann",
                                          "chunk")}))
        e.update(instance=fastest, max_err=max(r["max_err"] for r in rows))
        out.append(e)
    return out


def factor_entries(table, launches):
    """Phase 11's entries (``probe_entries``; chol_trsm_gram's variants B
    and C are two sites), each with "out_max", the largest output
    (chol_trisolve_apply's grow with lambda_max(M)^4, so its absolute
    error is large), the redesigned sites' with "status" and "design"."""
    fp = factor_probes
    out = probe_entries(fp, "factor_probes.cu", table, launches)
    for e in out:
        e["out_max"] = max(r["out_max"] for r in e["classes"])
        if e["name"] in fp.REDESIGNED:
            e.update(status="redesigned", design=fp.REDESIGNED[e["name"]])
    return out


def mxu_phase(chunks, stage_table):
    """Phase 12: kernel 1's Gram and Q probes on the tensor cores
    (tools/mxu_probes.py) on phase 4's chunks, beside phase 10's cuts
    (``stage_table``), then the shape sweep: the timed runs, with every
    probe kernel's launch counts set to 0 just before and read just after
    (each instance must have launched, the DMMA node-major Gram also at
    kernel 1's shared memory request), then each instance held to its
    plain version.  Returns (table, sweep, launches)."""
    mx = mxu_probes
    chunks = [(c, {k: None if v is None else v.cuda()
                   for k, v in inp.items()}, n_elem)
              for c, inp, n_elem in chunks]
    table, sweep, launches = mx.probe(
        chunks, [row["rounds"]["2"]["cuts"] for row in stage_table])
    del chunks
    mx.report(table, sweep)
    print(json.dumps({"mxu_probes": {
        "card": card_line(), "reps": kernel_stages.REPS,
        "launches": launches, "classes": table, "shapes": sweep,
        "shape_verdicts": mx.shape_verdicts(sweep)}}), flush=True)
    for msg in mx.failed(table, sweep):
        check(False, msg)
    for name, count in launches.items():
        check(count > 0, f"phase 12: {name} was not launched in the timed "
                         f"run: {launches}")
    for msg in mx.unlaunched_k1(table):
        check(False, f"phase 12: {msg}")
    return table, sweep, launches


def mxu_entries(table, sweep, launches):
    """Phase 12's entries: ``probe_entries`` of the route's chunks (the
    redesigned sites' with "status" and "design"), and the shape sweep's
    (r5_mxu_shapes.py:84, redesigned), its fastest instance at (132, 80)
    with every shape in "classes"."""
    mx = mxu_probes
    out = probe_entries(mx, "mxu_probes.cu", table, launches)
    for e in out:
        if e["name"] in mx.REDESIGNED:
            e.update(status="redesigned", design=mx.REDESIGNED[e["name"]])
    at = [r for r in sweep if (r["m"], r["n"], r["split"]) == (132, 80, 0)]
    best = min(at, key=lambda r: r["ms"])
    out.append({"name": mx.SHAPES_ANSWER, "route": "cuda",
                "status": "redesigned",
                "design": mx.REDESIGNED[mx.SHAPES_ANSWER],
                "source": "ninpol_tpu_torch/csrc/mxu_probes.cu",
                "replaces": site_of(mx.SHAPES_ANSWER),
                "launches": launches[mx.SHAPES_ANSWER],
                "max_abs_err": max(r["max_abs_err"] for r in sweep),
                **{k: best[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
                "instance": f"gram_tc[{best['precision']},minor] at "
                            f"(132, 80), {best['nodes']} nodes",
                "max_err": max(r["max_err"] for r in sweep),
                "classes": sweep})
    return out


def input_phase(chunks, stage_table):
    """Phase 13: kernel 1's input stream (tools/input_probes.py) on phase
    4's chunks, beside kernel 1's floor cut (timed by the probe as its
    instances are, and phase 10's from ``stage_table``): the timed run,
    with both probe kernels' launch counts set to 0 just before and read
    just after (each instance must have launched), then each instance held
    to its plain version.  Returns (table, launches)."""
    ip = input_probes
    chunks = [(c, {k: None if v is None else v.cuda()
                   for k, v in inp.items()}, n_elem)
              for c, inp, n_elem in chunks]
    table, launches = ip.probe(chunks)
    del chunks
    for row, stages in zip(table, stage_table):
        cut = stages["rounds"]["2"]["cuts"][0]
        check(cut["stop"] == "floor", f"phase 10's first cut is {cut['stop']}")
        row["phase10_floor_ms"] = cut["ms"]
        print(f"# phase 13: ({row['E']}, {row['F']}) floor cut "
              f"{row['floor_ms']:.4f} ms with L2 flushed, phase 10's "
              f"{cut['ms']:.4f} ms", flush=True)
    ip.report(table)
    print(json.dumps({"input_probes": {
        "card": card_line(), "reps": kernel_stages.REPS,
        "flush_bytes": ip.FLUSH_BYTES, "launches": launches,
        "classes": table}}), flush=True)
    for msg in ip.failed(table):
        check(False, msg)
    for name, count in launches.items():
        check(count > 0, f"phase 13: {name} was not launched in the timed "
                         f"run: {launches}")
    return table, launches


def input_entries(table, launches):
    """Phase 13's entries (``probe_entries``), the redesigned sites' with
    "status" and "design"."""
    ip = input_probes
    out = probe_entries(ip, "input_probes.cu", table, launches)
    for e in out:
        if e["name"] in ip.REDESIGNED:
            e.update(status="redesigned", design=ip.REDESIGNED[e["name"]])
    return out


def build_kernels():
    """Phase 2: one nvcc per kernel source, all started together."""
    from ninpol_tpu_torch.ops import cholqr as cq
    from ninpol_tpu_torch.ops import factor_probes as fp
    from ninpol_tpu_torch.ops import gls_solve as gs
    from ninpol_tpu_torch.ops import input_probes as ip
    from ninpol_tpu_torch.ops import mxu_probes as mp
    from ninpol_tpu_torch.ops import qr

    libs = (gs.library, gs.stage_library, cq.library, qr.library,
            fp.library, mp.library, ip.library)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as ex:
        for f in [ex.submit(lib.get) for lib in libs]:
            f.result()
    print(f"# kernel build: {time.perf_counter() - t0:.2f} s", flush=True)
    for lib in libs:
        print(f"# {lib.label}: {lib.build_seconds:.2f} s", flush=True)
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"#   {line.strip()}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=68,
                    help="tetra_mesh size (6 n^3 cells); 68 = 1,886,592")
    ap.add_argument("--hexa", type=int, default=128,
                    help="hexa_mesh size of phase 8 (n^3 cells); 128 = "
                         "2,097,152")
    ap.add_argument("--n-round1", type=int, default=20,
                    help="tetra_mesh size of phase 7 (precond_rounds = 1)")
    args = ap.parse_args()
    t_run = time.perf_counter()
    t_phase = [t_run]

    def phase_done(name):
        now = time.perf_counter()
        print(f"# phase {name}: {now - t_phase[0]:.2f} s", flush=True)
        t_phase[0] = now

    # ---- 1. the card
    card = card_line()
    print(f"# card: {card}", flush=True)
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    print(f"# python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    # ---- 2. build the kernels
    build_kernels()
    phase_done("2 build")

    # ---- 3. the problem, once for each route
    t0 = time.perf_counter()
    interp, build_s = build_problem(args.n)
    unfused, _ = build_problem(args.n)
    unfused.gls.fused = False     # the unfused route on one device
    tp = np.arange(interp.grid.n_points)
    print(f"# mesh: {interp.grid.n_elems} cells, {interp.grid.n_points} "
          f"points; grid build {build_s:.2f} s, both problems "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    phase_done("3 problem")

    # ---- 4. kernels vs plain versions
    chunks = kernel_stages.chunk_inputs(interp, tp)
    classes, rows = kernel_vs_plain(interp, chunks)
    phase_done("4 gls_solve")
    workspace_path(interp, tp, classes)
    phase_done("4b workspace")
    classes_u, rows_u = cholqr_vs_plain(unfused, tp)
    phase_done("4c cholqr")
    rows_q = csne_vs_plain(interp, tp)
    phase_done("4d csne")
    wide_routes(interp, tp, classes)
    phase_done("4e wide")
    _, rows_1 = kernel_vs_plain(interp, chunks, rounds=1)
    # phase 10's inputs wait on the host
    chunks = [(c, {k: None if v is None else v.cpu()
                   for k, v in inp.items()}, n_elem)
              for c, inp, n_elem in chunks]
    n_refine = interp.gls.n_refine
    phase_done("4f gls_solve rounds=1")

    # ---- 5. main path, the three routes, and "refined"
    W, NW, stats = main_path(interp, tp, classes, "fused")
    profile_main_path(interp, tp, "fused")
    phase_done("5 fused")
    Wu, NWu, stats_u = main_path(unfused, tp, classes_u, "shard_geometry")
    profile_main_path(unfused, tp, "shard_geometry")
    phase_done("5b shard_geometry")
    interp.gls.solver = "pallas"
    Wc, NWc, stats_c = main_path(interp, tp, classes, "pallas")
    profile_main_path(interp, tp, "pallas")
    phase_done("5c pallas")
    interp.gls.solver = "refined"
    Wr, NWr, stats_r = main_path(interp, tp, classes, "refined",
                                 max_bad=None, with_csr=False)
    interp.gls.solver = "auto"
    refined_vs_fused(interp, tp)
    phase_done("5d refined")
    print("# routes " + json.dumps({
        "fused_best_s": stats["best_s"],
        "shard_geometry_best_s": stats_u["best_s"],
        "pallas_best_s": stats_c["best_s"],
        "refined_best_s": stats_r["best_s"],
        "shard_geometry_over_fused": stats_u["best_s"] / stats["best_s"],
        "pallas_over_fused": stats_c["best_s"] / stats["best_s"],
        "refined_over_fused": stats_r["best_s"] / stats["best_s"],
        "n_bad": {"fused": stats["n_bad"],
                  "shard_geometry": stats_u["n_bad"],
                  "pallas": stats_c["n_bad"],
                  "refined": stats_r["n_bad"]}}), flush=True)
    tracing_phase(interp, unfused, tp, (W, NW), (Wu, NWu),
                  stats["chunks_per_run"])
    phase_done("5e tracing")

    # ---- 6. oracle, and the routes against each other
    oracle_check(interp, {"fused": (W, NW), "shard_geometry": (Wu, NWu),
                          "pallas": (Wc, NWc), "refined": (Wr, NWr)})
    scale = max(np.abs(W).max(), 1.0)
    for label, (Wx, NWx) in (("shard_geometry", (Wu, NWu)),
                             ("pallas", (Wc, NWc)),
                             ("refined", (Wr, NWr))):
        gap = max(np.abs(Wx - W).max(), np.abs(NWx - NW).max()) / scale
        print(f"# {label} vs fused " + json.dumps(
            {"max_scaled_diff": float(gap)}), flush=True)
        check(gap <= TOL_ORACLE, f"{label} weights differ from the fused "
                                 f"route's by {gap:.3e} scaled")
    del unfused, Wr, NWr
    phase_done("6 oracle")

    # ---- 7. the single-round preconditioner through the public API
    one_round_route(min(args.n, args.n_round1))
    phase_done("7 rounds=1 route")

    # ---- 8. IDW and LS on the tet mesh and on a hexa mesh
    _, simple_w = simple_methods(interp, f"tetra_mesh({args.n})")
    phase_done("8 idw/ls tetra")
    del interp
    t0 = time.perf_counter()
    hexa, hexa_s = build_problem(args.hexa, family="hexa")
    print(f"# hexa mesh: {hexa.grid.n_elems} cells, {hexa.grid.n_points} "
          f"points; grid build {hexa_s:.2f} s, problem "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    simple_methods(hexa, f"hexa_mesh({args.hexa})")
    del hexa
    phase_done("8 idw/ls hexa")

    # ---- 9. multi-device: replicated and partitioned geometry
    mesh_stats = mesh_phase(args.n, {
        "fused": (W, NW, stats), "shard_geometry": (Wu, NWu, stats_u),
        "pallas": (Wc, NWc, stats_c), **simple_w})
    del W, NW, Wu, NWu, Wc, NWc, simple_w
    phase_done("9 mesh")

    # ---- 10. kernel 1's stage probe
    stage_table = stage_phase(chunks, rows, n_refine)
    phase_done("10 kernel stages")

    # ---- 11. kernel 1's factorization probes
    probe_table, probe_launches = factor_phase(chunks, stage_table)
    phase_done("11 factor probes")

    # ---- 12. kernel 1's Gram and Q probes on the tensor cores
    mxu_table, mxu_sweep, mxu_launches = mxu_phase(chunks, stage_table)
    phase_done("12 mxu probes")

    # ---- 13. kernel 1's input stream
    input_table, input_launches = input_phase(chunks, stage_table)
    phase_done("13 input probes")
    print(f"# total: {time.perf_counter() - t_run:.2f} s", flush=True)

    top = max(rows, key=lambda r: r["nodes_in_class"])
    kernels = [entry("gls_solve", "gls_solve.cu", 849,
                     stats["launches"]["gls_solve"], rows + rows_1, top)]
    # the single-round instance (precond_rounds = 1), timed on the same
    # class; its launches are phase 7's, off the main path
    top_1 = max(rows_1, key=lambda r: r["nodes_in_class"])
    kernels[0]["rounds1"] = {k: top_1[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "E", "F",
        "with_neumann", "chunk", "sweeps")}
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
    kernels += factor_entries(probe_table, probe_launches)
    kernels += mxu_entries(mxu_table, mxu_sweep, mxu_launches)
    kernels += input_entries(input_table, input_launches)
    print("# mesh " + json.dumps(mesh_stats), flush=True)
    print(card, flush=True)            # nvidia-smi name, power.limit
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
