"""Kernel 1's factorization probes on the card: design alternatives for
the two factorizations of the fused GLS solve kernel, timed beside its
stage cuts.

The counterpart of the repo's TPU probes tools/trsm_probe.py,
trisolve_probe.py, chol_mxu_probe.py and chol_tri_probe.py (the sites and
what answers each: ``tools.SITES``).  The kernels are those of
ops/factor_probes.py, run on the route's own inputs: for the first chunk
of each stencil class of the default route's plan (``kernel_stages.
chunk_inputs``), the unfused route's float32 tensors (the equilibrated A,
G1 = A^T A + shift, L1^-1, G2 = (A L1^-T)^T (A L1^-T), Lc = L2^-1 L1^-1)
and one vector a node from a seeded generator.  Per class it prints:

  each kernel's ms (the best of kernel_stages.REPS single launches after
  a warm-up), its bound (``problem.bound`` of its FLOPs and device
  bytes), the nearest library composition's ms, its plain version's ms,
  its registers, spills, shared memory and blocks an SM, its error
  against its plain version and its largest output (``probe_errors``);
  every kernel also at kernel 1's shared memory (``K1_KERNELS``: the
  largest request of the chunks' classes, kernel 1's blocks an SM; ms,
  occupancy, error and launches under ``_k1``), as it would run inside
  it; chol_factor also on G2 and each chol_trisolve_apply instance also
  at applies = 0 (the factor and the staging alone, at both requests);
  the stage cuts it would replace (kernel 1's, ``kernel_stages.
  time_cuts`` at rounds = 2) and the unfused route's kernels beside it;
  the TPU probes' verdicts on these times (``verdicts``).

Run on the card (the kernels are built from csrc/ on first use):

    python -m ninpol_tpu_torch.tools.factor_probes [--n 68]

It prints ``#`` lines, then one JSON line ``{"factor_probes": ...}``.
Nothing falls back: a kernel that does not build or launch raises, and
one past its tolerance fails the run after that line.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess

import numpy as np
import torch

from . import kernel_stages as ks
from .problem import bound, build_problem

# Mapply's count in the TPU probe's solve variant (trisolve_probe.py:145):
# the route's preconditioner applications at rounds = 2, sweeps + 1
APPLIES = 4
SEED = 0
# each kernel against its plain version, per node over a scale (the
# largest error of a node that no factor flags): the float32 products
# (G2) to CUT_TOL of the same product of the operands' magnitudes
# (|A| |L1^-1|^T, as kernel_stages holds gram2); the factor, the inverse
# and the applies to CUT_TOL of their own magnitude; every one also
# within CHOL_RATIO times the plain version's own distance from the same
# function in float64 on the same inputs, as kernel_stages holds chol1
TOL = ks.CUT_TOL["chol1"]
# (kernel, the wrapper's arguments) of every instance timed:
# chol_trsm_gram after the elimination's factor (width 0, the TPU
# probe's variant B) or tensor-core panels (variant C); chol_linv_tc's
# panel widths (chol_mxu_probe.py's super-panels), and at kernel 1's
# width with a right factor (mul_right: L2^-1 L1^-1 of G2 and L1^-1,
# the route's chol2); chol_trisolve_apply's rows a block of its solves
# (1: the TPU probe's column sweep)
CONFIGS = (("chol_factor", {}),
           *(("chol_trsm_gram", {"width": w}) for w in (0, 8, 16, 32)),
           *(("chol_linv_tc", {"width": w}) for w in (8, 16, 32, 48)),
           ("chol_linv_tc", {"width": 16, "mul_right": True}),
           *(("chol_trisolve_apply", {"block": b}) for b in (1, 8)))
# the kernels also timed and held at kernel 1's shared memory request
K1_KERNELS = ("chol_factor", "chol_trsm_gram", "chol_linv_tc",
              "chol_trisolve_apply")
# the sites whose kernels were designed a second time, for the card: how
_FACTOR = ("blocked_factor.cuh's factor: G's triangle staged in float64 "
           "8 x 8 blocks, a lead warp factoring each diagonal block a step "
           "ahead of seven workers on FP64 m16n8k8, two block barriers a "
           "step")
REDESIGNED = {
    "chol_factor": _FACTOR + "; L out rounded once in whole rows",
    "chol_trisolve_apply": _FACTOR + "; Li by one cp.async.bulk during the "
                           "factor, widened into a packed float64 "
                           "triangle; Li v, Li^T y and (block 8) both "
                           "solves on all 8 warps, a warp a block row, one "
                           "block barrier a block step",
    "chol_trsm_gram": "A by one cp.async.bulk during the elimination's "
                      "factor; X^T = A L^-T a warp an 8-row tile in float64 "
                      "registers and X X^T on FP64 m16n8k8",
    "chol_trsm_gram (tensor-core factor)": _FACTOR + "; A by one "
                                           "cp.async.bulk meanwhile; X^T "
                                           "and X X^T on FP64 m16n8k8",
    "chol_linv_tc": _FACTOR + "; L^-1's block rows formed inside the "
                    "factor's steps"}


def label(kernel, kw):
    """An instance's name: the kernel and its arguments."""
    return kernel + ("[" + ",".join(f"{k}={v}" for k, v in kw.items()) + "]"
                     if kw else "")


def function(kernel, kw):
    """The function an instance computes, the key of its plain version,
    library call and work: its kernel, "chol_linv_tc (mul_right)" with a
    right factor."""
    return f"{kernel} (mul_right)" if kw.get("mul_right") else kernel


def answer(kernel, kw):
    """The name under which ``tools.SITES`` lists the instance: its
    ``function``, but "chol_trsm_gram (tensor-core factor)" for
    chol_trsm_gram after tensor-core panels (the TPU probe's variant C, a
    site of its own)."""
    if kernel == "chol_trsm_gram" and kw["width"]:
        return "chol_trsm_gram (tensor-core factor)"
    return function(kernel, kw)


def instance(kw):
    """The wrapper's ``launches_by`` key of an instance: its width or
    block (None without either), ("mul_right", width) with a right
    factor."""
    if kw.get("mul_right"):
        return ("mul_right", kw["width"])
    return next(iter(kw.values()), None)


def prepare(chunks):
    """The probes' inputs on each chunk (``kernel_stages.chunk_inputs``):
    [(head, tensors)], tensors the unfused route's As, G1, Li1, G2, Lc,
    its ``sick`` flags and a seeded vector v, on the chunk's device."""
    from ..ops import cholqr as cq
    from ..ops.gls_solve import assemble, incidence, node_active

    out = []
    for c, inp, _ in chunks:
        S1, S2, Sb = incidence(inp["pair"], inp["ks"], inp["cv"],
                               inp["fv"], inp["isneu"])
        A = assemble(inp["dk"], inp["l1"], inp["l2"], inp["t1m"], inp["tt"],
                     inp["lb"], S1, S2, Sb, inp["cv"],
                     node_active(inp["pair"], inp["fv"], inp["valid"]))
        pc = cq.cholqr_factors(A, cq.KERNELS)
        B, m, n = pc["As"].shape
        gen = torch.Generator(device=A.device).manual_seed(SEED)
        v = torch.randn((B, n), generator=gen, device=A.device,
                        dtype=torch.float32)
        head = {"E": c["E"], "F": c["F"], "with_neumann": c["with_neumann"],
                "chunk": B, "m": m, "n": n}
        out.append((head, {k: pc[k] for k in ("As", "G1", "Li1", "G2", "Lc",
                                              "sick")} | {"v": v}))
        del A, S1, S2, Sb, pc
    return out


def setup(prepared):
    """Per chunk, before the timed run: kernel 1's dynamic shared memory
    and blocks an SM at its class (``k1_smem``, ``k1_blocks_per_sm``) and
    the request that stands for them in every chunk (``k1_request``, the
    largest of the chunks': at (12, 24) kernel 1 is held to its (24, 36)
    blocks an SM by registers, PERF.md §6 PR 14)."""
    from ..ops import gls_solve as gs

    for head, _ in prepared:
        occ = gs.occupancy(head["E"], head["F"], head["with_neumann"], 2)
        head["k1_smem"] = occ["smem_bytes"]
        head["k1_blocks_per_sm"] = occ["blocks_per_sm"]
    request = max(head["k1_smem"] for head, _ in prepared)
    for head, _ in prepared:
        head["k1_request"] = request


def run(kernel, kw, t, plain=False, smem_bytes=0):
    """One call of probe ``kernel`` with the arguments ``kw`` on the
    tensors ``t`` (the wrapper, or with ``plain`` its plain version), a
    K1_KERNELS wrapper at a shared memory request of ``smem_bytes``;
    chol_linv_tc with ``mul_right`` on G2 and L1^-1, as the route's
    chol2."""
    from ..ops import factor_probes as fp

    right = kw.get("mul_right")
    kw = {k: v for k, v in kw.items() if k != "mul_right"}
    if smem_bytes:
        kw["smem_bytes"] = smem_bytes
    fn = getattr(fp, f"{kernel}_reference") if plain else \
        functools.partial(getattr(fp, kernel), **kw)
    if kernel == "chol_trsm_gram":
        return fn(t["As"], t["G1"])
    if kernel == "chol_trisolve_apply":
        return fn(t["G2"], t["Li1"], t["v"], applies=APPLIES)
    if right:
        return fn(t["G2"], mul_right=t["Li1"])
    return fn(t["G1"])


def library_call(name, t):
    """The nearest composition of PyTorch library calls to the function
    ``name`` (``function``) on ``t``: cholesky_ex (chol_factor: the same
    function where no pivot is clamped), then triangular solves and
    products."""
    kernel = name.split(" ")[0]
    G = t["G1"] if name in ("chol_factor", "chol_trsm_gram",
                            "chol_linv_tc") else t["G2"]
    cholesky = torch.linalg.cholesky_ex
    if kernel == "chol_factor":
        return lambda: cholesky(G).L
    if kernel == "chol_trsm_gram":
        def trsm_gram():
            X = torch.linalg.solve_triangular(
                cholesky(G).L, t["As"].transpose(1, 2), upper=False)
            return torch.bmm(X, X.transpose(1, 2))
        return trsm_gram
    if kernel == "chol_linv_tc":
        eye = torch.eye(G.shape[1], dtype=G.dtype, device=G.device)
        rhs = t["Li1"] if name != kernel else eye.expand(G.shape)
        return lambda: torch.linalg.solve_triangular(
            cholesky(G).L, rhs, upper=False)

    def trisolve():
        L, Li, v = cholesky(G).L, t["Li1"], t["v"][:, :, None]
        for _ in range(APPLIES):
            v = torch.bmm(Li.transpose(1, 2),
                          torch.cholesky_solve(torch.bmm(Li, v), L))
        return v[:, :, 0]
    return trisolve


def work(name, head):
    """(FP32 FLOPs, device bytes) of the function ``name`` (``function``)
    on the chunk: every node is factored, each input read once and each
    output written once, triangles counted as triangles: of G (symmetric)
    and of Li (lower triangular) only the lower triangle is read, by every
    kernel; the outputs are the dense (B, n, n) or (B, n) tensors they
    return.  L^-1 P needs the factor and one triangular solve of the
    lower-triangular P, n^3 / 3 FLOPs each, as L^-1 does."""
    B, m, n = head["chunk"], head["m"], head["n"]
    square, tri = B * n * n * 4, B * n * (n + 1) // 2 * 4
    factor = n ** 3 / 3
    if name == "chol_factor":
        return B * factor, tri + square
    if name == "chol_trsm_gram":
        # the factor, X = L^-1 A^T (m n^2), the symmetric X X^T
        return (B * (factor + m * n * n + m * n * (n + 1)),
                B * m * n * 4 + tri + square)
    if name == "chol_linv_tc":
        return B * 2 * factor, tri + square
    if name == "chol_linv_tc (mul_right)":
        return B * 2 * factor, 2 * tri + square
    # the factor, then each apply: Li v and Li^T y on the triangle, two
    # triangular solves
    return (B * (factor + APPLIES * (2 * n * (n + 1) + 2 * n * n)),
            2 * tri + 2 * B * n * 4)


def stage_ms(cuts):
    """The stage-cut times a probe would replace, from a ``time_cuts``
    list at rounds = 2: chol1, chol2 and the sweeps' stage ms, and chol1
    to gram2 (the cumulative gram2 less gram1: the factorization, Q and
    G2, what the TPU's trsm variants A, B and C compute)."""
    at = {c["stop"]: c for c in cuts}
    return {"chol1": at["chol1"]["stage_ms"],
            "chol2": at["chol2"]["stage_ms"],
            "sweeps": at["sweeps"]["stage_ms"],
            "chol1_to_gram2": at["gram2"]["ms"] - at["gram1"]["ms"],
            "all": at["all"]["ms"]}


def time_probes(prepared, cuts):
    """Every probe kernel's ms, bound, occupancy, plain and library ms on
    each prepared chunk (``setup`` done), K1_KERNELS' also at kernel 1's
    request with their launches there, beside the stage cuts
    (``cuts[i]``: a ``time_cuts`` list at rounds = 2 for chunk i) and the
    unfused route's kernels on the same tensors.  The probe kernels'
    launches here are the path ``launches`` counts."""
    from ..ops import cholqr as cq
    from ..ops import factor_probes as fp

    table = []
    for (head, t), chunk_cuts in zip(prepared, cuts):
        row = dict(head, kernels={})
        plain, library = {}, {}
        for kernel, kw in CONFIGS:
            name = function(kernel, kw)
            f32, nbytes = work(name, head)
            bound_ms, bound_by = bound(f32, nbytes)
            if name not in plain:
                plain[name] = ks.once_ms(
                    lambda: run(kernel, kw, t, plain=True))
                library[name] = ks.best_ms(library_call(name, t))
            row["kernels"][label(kernel, kw)] = {
                "kernel": kernel, **kw,
                "ms": ks.best_ms(lambda: run(kernel, kw, t)),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "plain_ms": plain[name], "library_ms": library[name],
                "occupancy": fp.occupancy(kernel, head["m"], head["n"],
                                          **kw)}
            if kernel in K1_KERNELS:
                request, wrapper = head["k1_request"], getattr(fp, kernel)
                before = wrapper.launches
                row["kernels"][label(kernel, kw)].update(
                    ms_k1=ks.best_ms(lambda: run(kernel, kw, t,
                                                 smem_bytes=request)),
                    launches_k1=wrapper.launches - before,
                    occupancy_k1=fp.occupancy(kernel, head["m"], head["n"],
                                              **kw, smem_bytes=request))
            if kernel == "chol_trisolve_apply":
                # the factor and the staging alone, at both requests
                for key, smem in (("ms_applies0", 0),
                                  ("ms_applies0_k1", head["k1_request"])):
                    row["kernels"][label(kernel, kw)][key] = ks.best_ms(
                        lambda: fp.chol_trisolve_apply(
                            t["G2"], t["Li1"], t["v"], applies=0,
                            smem_bytes=smem, **kw))
        # the baseline the f32_rule subtracts: the factor of G2
        row["kernels"]["chol_factor"]["ms_on_g2"] = ks.best_ms(
            lambda: fp.chol_factor(t["G2"]))
        row["standalone"] = {
            "chol_linv_f32": ks.best_ms(lambda: cq.chol_linv_f32(t["G1"])),
            "chol_linv_f32_p": ks.best_ms(
                lambda: cq.chol_linv_f32(t["G2"], mul_right=t["Li1"])),
            "round2_gram_f32": ks.best_ms(
                lambda: cq.round2_gram_f32(t["As"], t["Li1"])),
            "prec_apply_f32": ks.best_ms(
                lambda: cq.prec_apply_f32(t["Lc"], t["v"]))}
        row["stages"] = stage_ms(chunk_cuts)
        row["verdicts"] = verdicts(row)
        table.append(row)
    return table


def node_err(got, ref, scale, held):
    """The largest over the nodes ``held`` of max|got - ref| / max|scale|,
    per node."""
    d = (got - ref).abs().flatten(1).amax(dim=1)
    s = scale.abs().flatten(1).amax(dim=1).clamp_min(1e-30)
    err = (d / s)[held]
    return float(err.max()) if len(err) else 0.0


def probe_errors(prepared):
    """Each probe kernel against its plain version on each prepared chunk:
    [{label: {"max_err", "plain_err", "tol", "max_abs_err", "out_max",
    "nodes"}}], K1_KERNELS' also "max_err_k1" and "max_abs_err_k1" at the
    head's ``k1_request``, held on the nodes the route flags no pivot of
    (TOL's comment).  ``out_max`` is the plain version's largest |output| on
    those nodes: the applies raise v by up to lambda_max(M)^4, so it says
    how far chol_trisolve_apply's results stay below float32's range."""
    from ..ops import factor_probes as fp

    out = []
    for head, t in prepared:
        held = ~t["sick"]
        f64 = {k: t[k].double() for k in ("As", "G1", "Li1", "G2", "v")}
        aQ = t["As"].abs() @ t["Li1"].abs().transpose(1, 2)
        scales = {"chol_trsm_gram": aQ.transpose(1, 2) @ aQ}
        exact = {"chol_factor": fp.chol_factor_reference(f64["G1"]),
                 "chol_trsm_gram": fp.chol_trsm_gram_reference(f64["As"],
                                                               f64["G1"]),
                 "chol_linv_tc": fp.chol_linv_tc_reference(f64["G1"]),
                 "chol_linv_tc (mul_right)": fp.chol_linv_tc_reference(
                     f64["G2"], mul_right=f64["Li1"]),
                 "chol_trisolve_apply": fp.chol_trisolve_apply_reference(
                     f64["G2"], f64["Li1"], f64["v"], applies=APPLIES)}
        refs, errs = {}, {}
        for kernel, kw in CONFIGS:
            name = function(kernel, kw)
            if name not in refs:
                refs[name] = run(kernel, kw, t, plain=True)
            ref = refs[name]
            got = run(kernel, kw, t)
            scale = scales.get(name, ref)
            plain_err = node_err(ref.double(), exact[name], scale, held)
            errs[label(kernel, kw)] = {
                "max_err": node_err(got, ref, scale, held),
                "plain_err": plain_err,
                "tol": max(TOL, ks.CHOL_RATIO * plain_err),
                "max_abs_err": float((got - ref)[held].abs().max())
                if held.any() else 0.0,
                "out_max": float(ref[held].abs().max())
                if held.any() else 0.0,
                "nodes": int(held.sum())}
            if kernel in K1_KERNELS:
                got = run(kernel, kw, t, smem_bytes=head["k1_request"])
                errs[label(kernel, kw)].update(
                    max_err_k1=node_err(got, ref, scale, held),
                    max_abs_err_k1=float((got - ref)[held].abs().max())
                    if held.any() else 0.0)
            del got
        out.append(errs)
        del f64, aQ, scales, exact, refs
    return out


def verdicts(row):
    """The TPU probes' verdicts, in their own terms, on the row's times:
      trsm       A (L^-1, Q and G2: chol_linv_f32 + round2_gram_f32
                 standalone, and kernel 1's cuts chol1 to gram2) against
                 chol_trsm_gram after the elimination (the probe's
                 variant B) and after tensor-core panels (variant C, the
                 fastest width);
      trisolve   trisolve_probe.py:173's rule, (solve4 - chol) < mapply4 +
                 (chol_linv - chol), i.e. solve4 < mapply4 + chol_linv,
                 with both sides on the blocked factor at kernel 1's
                 shared memory: the solves win iff chol_trisolve_apply <
                 APPLIES x prec_apply_f32 + chol_linv_tc with P (width
                 16), each at kernel 1's request, for each block of the
                 solves (1: the TPU probe's column sweep); beside it under
                 "f32_rule" the rule priced on the elimination:
                 chol_linv_f32 with P for chol_linv, chol_factor on G2
                 subtracted from both sides;
      chol_mxu   each chol_linv_tc width against chol_linv_f32's register
                 body and against the chol1 cut;
      chol2      chol_linv_tc with a right factor, at kernel 1's shared
                 memory, against chol_linv_f32 with P and the chol2 cut
                 (trisolve_probe.py:95's product, L2^-1 L1^-1)."""
    k, sa, st = row["kernels"], row["standalone"], row["stages"]
    a_standalone = sa["chol_linv_f32"] + sa["round2_gram_f32"]

    def trsm(width):
        return k[label("chol_trsm_gram", {"width": width})]["ms"]

    c_width = min((8, 16, 32), key=trsm)
    trsm_ms = {"B": trsm(0), "C": trsm(c_width)}
    chol = k["chol_factor"]["ms_on_g2"]
    right = k[label("chol_linv_tc", {"width": 16, "mul_right": True})]
    mapply = APPLIES * sa["prec_apply_f32"]
    solve = {str(b): k[label("chol_trisolve_apply", {"block": b})]
             for b in (1, 8)}

    def rule(explicit, solves):
        return {"explicit_ms": explicit, "blocks": {
            b: {"solves_ms": ms, "solves_win": ms < explicit}
            for b, ms in solves.items()}}
    return {
        "trsm": {"A_standalone_ms": a_standalone,
                 "A_stages_ms": st["chol1_to_gram2"], "C_width": c_width,
                 **{f"{v}_ms": ms for v, ms in trsm_ms.items()},
                 **{f"{v}_beats_A_standalone": ms < a_standalone
                    for v, ms in trsm_ms.items()},
                 **{f"{v}_beats_A_stages": ms < st["chol1_to_gram2"]
                    for v, ms in trsm_ms.items()}},
        "trisolve": {
            **rule(mapply + right["ms_k1"],
                   {b: r["ms_k1"] for b, r in solve.items()}),
            "f32_rule": rule(mapply + sa["chol_linv_f32_p"] - chol,
                             {b: r["ms"] - chol for b, r in solve.items()})},
        "chol_mxu": {str(w): {
            "ms": k[label("chol_linv_tc", {"width": w})]["ms"],
            "over_chol_linv_f32": k[label("chol_linv_tc", {"width": w})]["ms"]
            / sa["chol_linv_f32"],
            "over_chol1_cut": k[label("chol_linv_tc", {"width": w})]["ms"]
            / st["chol1"]} for w in (8, 16, 32, 48)},
        "chol2": {"ms": right["ms"], "ms_k1": right["ms_k1"],
                  "over_chol_linv_f32_p": right["ms_k1"]
                  / sa["chol_linv_f32_p"],
                  "over_chol2_cut": right["ms_k1"] / st["chol2"]}}


def report(table):
    """The table as ``#`` lines: one a kernel, then the verdicts."""
    for row in table:
        print(f"# factor_probes ({row['E']}, {row['F']}) with_neumann="
              f"{row['with_neumann']} chunk={row['chunk']} m={row['m']} "
              f"n={row['n']}", flush=True)
        for name, r in row["kernels"].items():
            occ = r["occupancy"]
            print(f"#   {name:>28}: {r['ms']:9.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library "
                  f"{r['library_ms']:.4f} ms, plain {r['plain_ms']:.2f} ms;"
                  f" {occ['registers']} registers, {occ['local_bytes']} "
                  f"spill bytes, {occ['smem_bytes']} B shared, "
                  f"{occ['blocks_per_sm']} blocks an SM"
                  + (f"; error {r['max_err']:.2e} (tol {r['tol']:.1e}, "
                     f"plain's own {r['plain_err']:.1e}), largest output "
                     f"{r['out_max']:.2e}" if "max_err" in r else ""),
                  flush=True)
            if "ms_k1" in r:
                occ = r["occupancy_k1"]
                print(f"#   {'at kernel 1 shared memory':>28}: "
                      f"{r['ms_k1']:9.4f} ms; {occ['smem_bytes']} B shared, "
                      f"{occ['blocks_per_sm']} blocks an SM, {r['launches_k1']}"
                      f" launches" + (f"; error {r['max_err_k1']:.2e}"
                                      if "max_err_k1" in r else ""),
                      flush=True)
            if "ms_applies0" in r:
                print(f"#   {'applies = 0 (factor, staging)':>28}: "
                      f"{r['ms_applies0']:9.4f} ms, {r['ms_applies0_k1']:.4f}"
                      f" ms at kernel 1's shared memory", flush=True)
        st, sa = row["stages"], row["standalone"]
        print(f"#   stage cuts: chol1 {st['chol1']:.4f}, chol1 to gram2 "
              f"{st['chol1_to_gram2']:.4f}, chol2 {st['chol2']:.4f}, sweeps "
              f"{st['sweeps']:.4f}, all {st['all']:.4f} ms; unfused: "
              f"chol_linv_f32 {sa['chol_linv_f32']:.4f}, with P "
              f"{sa['chol_linv_f32_p']:.4f}, round2_gram_f32 "
              f"{sa['round2_gram_f32']:.4f}, prec_apply_f32 "
              f"{sa['prec_apply_f32']:.4f} ms; chol_factor on G2 "
              f"{row['kernels']['chol_factor']['ms_on_g2']:.4f} ms",
              flush=True)
        v = row["verdicts"]
        tr, ts = v["trsm"], v["trisolve"]
        win = {True: "wins", False: "loses"}
        print(f"#   verdict trsm against A standalone "
              f"{tr['A_standalone_ms']:.4f} ms / A's stages "
              f"{tr['A_stages_ms']:.4f} ms: " + "; ".join(
                  f"{name} {tr[f'{v}_ms']:.4f} ms "
                  f"{win[tr[f'{v}_beats_A_standalone']]} / "
                  f"{win[tr[f'{v}_beats_A_stages']]}"
                  for v, name in (("B", "B (elimination factor)"),
                                  ("C", f"C (width {tr['C_width']})"))),
              flush=True)
        print("#   verdict trisolve at kernel 1's shared memory: " + "; ".join(
            f"block {w}: solves {'WIN' if b['solves_win'] else 'LOSE'}, "
            f"chol_trisolve_apply {b['solves_ms']:.4f} ms"
            for w, b in ts["blocks"].items())
            + f" vs {APPLIES} x prec_apply_f32 + chol_linv_tc with P = "
              f"{ts['explicit_ms']:.4f} ms", flush=True)
        f32 = ts["f32_rule"]
        print("#   (on chol_linv_f32's elimination: " + "; ".join(
            f"block {w}: solves {'WIN' if b['solves_win'] else 'LOSE'}, "
            f"chol_trisolve_apply - chol_factor = {b['solves_ms']:.4f} ms"
            for w, b in f32["blocks"].items())
            + f" vs {APPLIES} x prec_apply_f32 + (chol_linv_f32 with P - "
              f"chol_factor) = {f32['explicit_ms']:.4f} ms)", flush=True)
        print("#   verdict chol_mxu: " + ", ".join(
            f"width {w} {r['ms']:.4f} ms = {r['over_chol_linv_f32']:.2f}x "
            f"chol_linv_f32, {r['over_chol1_cut']:.2f}x the chol1 cut"
            for w, r in v["chol_mxu"].items()), flush=True)
        c2 = v["chol2"]
        print(f"#   verdict chol2: chol_linv_tc with P (width 16) "
              f"{c2['ms']:.4f} ms, {c2['ms_k1']:.4f} ms at kernel 1's shared "
              f"memory = {c2['over_chol_linv_f32_p']:.2f}x chol_linv_f32 "
              f"with P, {c2['over_chol2_cut']:.2f}x the chol2 cut",
              flush=True)


def failed(table):
    """The kernels of a table whose error, at either shared memory
    request, is past its tolerance."""
    return [f"({row['E']}, {row['F']}) {name}{at}: error {r[key]:.3e} > "
            f"{r['tol']:.1e}"
            for row in table for name, r in row["kernels"].items()
            for key, at in (("max_err", ""),
                            ("max_err_k1", " at kernel 1's shared memory"))
            if key in r and not r[key] <= r["tol"]]


def unlaunched_k1(table):
    """The K1_KERNELS instances that did not launch at kernel 1's shared
    memory in the timed run."""
    return [f"({row['E']}, {row['F']}) {name}: no launch at kernel 1's "
            f"shared memory" for row in table
            for name, r in row["kernels"].items()
            if r["kernel"] in K1_KERNELS and not r.get("launches_k1")]


def launch_counts():
    """Each instance's launches ({label: count}), from its wrapper's
    count by ``instance``."""
    from ..ops import factor_probes as fp

    return {label(kernel, kw): getattr(fp, kernel).launches_by[instance(kw)]
            for kernel, kw in CONFIGS}


def reset_counts():
    from ..ops import factor_probes as fp

    for w in fp.KERNELS:
        w.launches = 0
        w.launches_by.clear()


def probe(chunks, cuts):
    """The whole probe on ``chunks``: the timed path (its launches
    counted from 0), then each kernel against its plain version, merged
    into the table; returns (table, launches)."""
    prepared = prepare(chunks)
    setup(prepared)
    reset_counts()
    table = time_probes(prepared, cuts)
    launches = launch_counts()
    for row, errs in zip(table, probe_errors(prepared)):
        for name, e in errs.items():
            row["kernels"][name].update(e)
    return table, launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=68,
                    help="tetra_mesh size (6 n^3 cells); 68 = 1,886,592")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("factor_probes needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"# card: {card}", flush=True)
    interp, _ = build_problem(args.n)
    chunks = ks.chunk_inputs(interp, np.arange(interp.grid.n_points))
    sweeps = ks.route_sweeps(interp.gls.n_refine, 2)
    cuts = [ks.time_cuts(inp, 2, sweeps) for _, inp, _ in chunks]
    table, launches = probe(chunks, cuts)
    report(table)
    print(json.dumps({"factor_probes": {
        "card": card, "mesh": f"tetra_mesh({args.n})", "reps": ks.REPS,
        "launches": launches, "classes": table}}), flush=True)
    bad = failed(table) + [f"{k}: no launch" for k, n in launches.items()
                           if n == 0] + unlaunched_k1(table)
    if bad:
        raise SystemExit("\n".join(bad))


if __name__ == "__main__":
    main()
