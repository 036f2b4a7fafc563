"""Kernel 1's Gram and Q stages on the tensor cores: the probe kernels of
ops/mxu_probes.py on the card, timed beside kernel 1's stage cuts and the
unfused route's CUDA-core Gram kernels.

The counterpart of the repo's TPU probes tools/mxu_probe.py and
r5_mxu_shapes.py (the sites and what answers each: ``tools.SITES``).  On
the route's own inputs: for the first chunk of each stencil class of the
default route's plan (``kernel_stages.chunk_inputs``), the unfused
route's float32 tensors (the equilibrated A, L1^-1 as Li, G1), laid out
node-minor by node_transpose for the node-minor instances.  Per class it
prints:

  each instance's ms (the best of kernel_stages.REPS single launches
  after a warm-up), its bound (``problem.bound`` of the FLOPs the
  function needs at its precision's peak, and its device bytes), the
  library call that computes the same function (``library_call``), its
  plain version's ms, its registers, spills, shared memory and blocks an
  SM, its error against its plain version and against float64;
  K1_CONFIGS' instance (the DMMA node-major Gram, kernel 1's gram1 stage
  on the tensor cores) also at kernel 1's shared memory request
  (``factor_probes.setup``: the largest of the chunks' classes'), its ms,
  launches, occupancy and errors under ``_k1``;
  the stage cuts it would replace (kernel 1's gram1, q and gram2,
  ``kernel_stages.time_cuts`` at rounds = 2) and the unfused route's
  gram_f32 and round2_gram_f32 on the same tensors;
  the TPU probes' verdicts on these times (``verdicts``), and the gram1
  question of ROADMAP.md section 1 item 1.

Then the shape sweep of r5_mxu_shapes.py: the node-minor Gram on SWEEP_NODES
synthetic nodes (standard normal x 0.1 from a seeded torch.Generator) at
its seven (m, n, split) shapes, with its verdicts (``shape_verdicts``).

Run on the card (the kernels are built from csrc/ on first use):

    python -m ninpol_tpu_torch.tools.mxu_probes [--n 68]

It prints ``#`` lines, then one JSON line ``{"mxu_probes": ...}``.
Nothing falls back: a kernel that does not build or launch raises, and
one past its tolerance fails the run after that line.  float32 products
of the plain versions and library calls run with TF32 off
(torch.backends.cuda.matmul.allow_tf32 = False, PyTorch's default).
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess

import numpy as np
import torch

from . import kernel_stages as ks
from .factor_probes import setup
from .problem import PEAK_BF16, PEAK_FP64, PEAK_TF32, bound, build_problem

SEED = 0
# each instance against its plain version, per node over the largest
# entry of the same product of the operands' magnitudes (|A|^T |A|,
# |A| |Li|^T, |Q|^T |Q| with |Q| = |A| |Li|^T): another order of the same
# sums, as kernel_stages.CUT_TOL holds the float32 stages;
# node_transpose bit for bit
TOL = ks.CUT_TOL["gram1"]
SWEEP_NODES = 16384
# r5_mxu_shapes.py's (m, n, split): H1 m in {128, 132, 136, 168} and
# 132 split at row 128, at n = 80; H2 n in {72, 128} at m = 132
SHAPES = ((128, 80, 0), (132, 80, 0), (136, 80, 0), (168, 80, 0),
          (132, 80, 128), (132, 72, 0), (132, 128, 0))
FLOAT32_TRUE = ("dmma", "tf32x3")
# (kernel, the wrapper's arguments) of every instance timed on a chunk
CONFIGS = (("node_transpose", {"direction": "in"}),
           ("node_transpose", {"direction": "out"}),
           *(("gram_tc", {"precision": p, "layout": "major"})
             for p in ("dmma", "tf32x3", "bf16")),
           *(("gram_tc", {"precision": p, "layout": "minor"})
             for p in FLOAT32_TRUE),
           *(("q_tc", {"precision": p}) for p in FLOAT32_TRUE),
           *(("gram_q_gram_tc", {"precision": p, "layout": lay})
             for lay in ("major", "minor") for p in FLOAT32_TRUE))
# the instances also timed and held at kernel 1's shared memory request
K1_CONFIGS = (("gram_tc", {"precision": "dmma", "layout": "major"}),)
# the TPU site each instance answers (tools.SITES' "by")
_ANSWERS = {("node_transpose", "in"): "node_transpose (in)",
            ("node_transpose", "out"): "node_transpose (out)",
            ("gram_tc", "major"): "gram_tc (node-major)",
            ("gram_tc", "bf16"): "gram_tc (bf16)",
            ("gram_tc", "minor"): "gram_tc (node-minor)"}
SHAPES_ANSWER = "gram_tc (shapes)"
# the sites whose kernels were designed a second time, for the card: how
_GRAM_MAJOR = ("persistent blocks of 16 MMA and 8 converting warps, one an "
               "SM; a node's A by one cp.async.bulk a node ahead, converted "
               "once into a node-sized plane while the MMA warps run the "
               "last node's products with no barrier between k steps; G "
               "mirrored over the plane and out by one bulk store")
_GRAM_MINOR = ("groups of 8 nodes of a tile, so every copy of A (16-byte "
               "cp.async, 8 rows a step) and every store of G moves whole "
               "32-byte sectors; each node's rows converted once into its "
               "plane; a block's 16 warps a super tile of 4 nodes each, the "
               "group's other super tiles further items; persistent blocks")
REDESIGNED = {
    "gram_tc (node-major)": _GRAM_MAJOR,
    "gram_tc (bf16)": _GRAM_MAJOR,
    "gram_tc (node-minor)": _GRAM_MINOR,
    SHAPES_ANSWER: _GRAM_MINOR,
    "q_tc": "persistent blocks; a node's A and Li each by one cp.async.bulk, "
            "the next node's Li in flight; Li converted once a node into an "
            "operand plane, A's fragments once into registers (a warp a row "
            "tile); Q out by one bulk store a node",
    "gram_q_gram_tc": "persistent blocks of 16 warps; A (double-buffered) "
                      "and Li by cp.async.bulk node-major; 48-row steps, "
                      "each operand converted once; a warp one super tile "
                      "of G1 and of G2 and one Q unit a step; G1 and G2 out "
                      "by bulk stores"}


def label(kernel, kw):
    """An instance's name (``mxu_probes.instance``)."""
    from ..ops.mxu_probes import instance

    return instance(kernel, **kw)


def answer(kernel, kw):
    """The name under which ``tools.SITES`` lists the instance's site."""
    key = kw.get("direction") or ("bf16" if kw.get("precision") == "bf16"
                                  else kw.get("layout"))
    return _ANSWERS.get((kernel, key), kernel)


def prepare(chunks):
    """The probes' inputs on each chunk (``kernel_stages.chunk_inputs``):
    [(head, tensors)], tensors the unfused route's As, Li1 and G1 on the
    chunk's device, and As and Li1 node-minor (``As_minor``,
    ``Li1_minor``, by node_transpose)."""
    from ..ops import cholqr as cq
    from ..ops import mxu_probes as mp
    from ..ops.gls_solve import assemble, incidence, node_active

    out = []
    for c, inp, _ in chunks:
        S1, S2, Sb = incidence(inp["pair"], inp["ks"], inp["cv"],
                               inp["fv"], inp["isneu"])
        A = assemble(inp["dk"], inp["l1"], inp["l2"], inp["t1m"], inp["tt"],
                     inp["lb"], S1, S2, Sb, inp["cv"],
                     node_active(inp["pair"], inp["fv"], inp["valid"]))
        pc = cq.cholqr_factors(A, cq.KERNELS, rounds=1)
        B, m, n = pc["As"].shape
        t = {k: pc[k] for k in ("As", "Li1", "G1")}
        t["As_minor"] = mp.node_transpose(t["As"], "out")
        t["Li1_minor"] = mp.node_transpose(t["Li1"], "out")
        head = {"E": c["E"], "F": c["F"], "with_neumann": c["with_neumann"],
                "chunk": B, "m": m, "n": n}
        out.append((head, t))
        del A, S1, S2, Sb, pc
    return out


def run(kernel, kw, t, plain=False, smem_bytes=0):
    """One call of ``kernel`` with the arguments ``kw`` on the tensors
    ``t`` (the wrapper, or with ``plain`` its plain version), its outputs
    as returned (node-minor instances: node-minor); a K1_CONFIGS wrapper at
    a shared memory request of ``smem_bytes``."""
    from ..ops import mxu_probes as mp

    B = t["As"].shape[0]
    if kernel == "node_transpose":
        fn = mp.node_transpose_reference if plain else mp.node_transpose
        if kw["direction"] == "in":
            return fn(t["As_minor"], "in", B)
        return fn(t["G1"], "out")
    minor = kw.get("layout") == "minor"
    A = t["As_minor"] if minor else t["As"]
    Li = t["Li1_minor"] if minor else t["Li1"]
    if plain:
        fn = getattr(mp, f"{kernel}_reference")
        p = kw["precision"]
        args = (A,) if kernel == "gram_tc" else (A, Li)
        return mp._minor_call(lambda *xs: fn(*xs, p), kw.get("layout", "major"),
                              B, *args)
    fn = functools.partial(getattr(mp, kernel), **kw)
    extra = {"nodes": B} if minor else {}
    if smem_bytes:
        extra["smem_bytes"] = smem_bytes
    if kernel == "gram_tc":
        return fn(A, **extra)
    return fn(A, Li, **extra)


def major(out, kernel, kw, B):
    """An instance's outputs as a tuple of node-major tensors."""
    from ..ops.mxu_probes import node_transpose_reference

    outs = out if isinstance(out, tuple) else (out,)
    if kw.get("layout") == "minor" or kw.get("direction") == "out":
        outs = tuple(node_transpose_reference(o, "in", B) for o in outs)
    return outs


def to_major(x):
    """A node-minor (T, r, c, 128) tensor node-major, (T 128, r, c)."""
    return x.permute(0, 3, 1, 2).reshape(-1, *x.shape[1:3])


def to_minor(x):
    """A node-major (T 128, r, c) tensor node-minor."""
    from ..ops.mxu_probes import NT

    return x.reshape(-1, NT, *x.shape[1:]).permute(0, 2, 3, 1).contiguous()


def minor_gram_library(Am, split=0):
    """The library calls of the node-minor Gram: to node-major, bmm (twice
    and added for a split), back."""
    X = to_major(Am)
    if not split:
        return to_minor(torch.bmm(X.transpose(1, 2), X))
    X1, X2 = X[:, :split], X[:, split:]
    return to_minor(torch.bmm(X1.transpose(1, 2), X1)
                    + torch.bmm(X2.transpose(1, 2), X2))


def library_call(kernel, kw, t):
    """The PyTorch library calls that compute ``kernel``'s function on the
    same inputs: torch.bmm in float32 with TF32 off (bf16: on the
    operands cast to bf16 beforehand, into float32 by out_dtype, which
    CUDA tensors take); node-minor instances add the permute(...).contiguous()
    each way; node_transpose is that copy alone (on the chunk padded to
    whole tiles)."""
    from ..ops.mxu_probes import NT

    B, m, n = t["As"].shape
    T = -(-B // NT)
    if kernel == "node_transpose":
        if kw["direction"] == "in":
            return lambda: to_major(t["As_minor"]).contiguous()
        G1p = torch.zeros((T * NT, n, n), dtype=torch.float32,
                          device=t["G1"].device)
        G1p[:B] = t["G1"]
        return lambda: to_minor(G1p)
    minor = kw.get("layout") == "minor"
    A = t["As_minor"] if minor else t["As"]
    Li = t["Li1_minor"] if minor else t["Li1"]

    def gram(X):
        return torch.bmm(X.transpose(1, 2), X)

    if kernel == "gram_tc":
        if kw["precision"] == "bf16":
            Ab = A.to(torch.bfloat16)
            return lambda: torch.bmm(Ab.transpose(1, 2), Ab,
                                     out_dtype=torch.float32)
        return (lambda: minor_gram_library(A)) if minor else lambda: gram(A)

    def fn():
        X, L = (to_major(A), to_major(Li)) if minor else (A, Li)
        Q = torch.bmm(X, L.transpose(1, 2))
        outs = (Q,) if kernel == "q_tc" else (gram(X), gram(Q))
        return tuple(to_minor(o) for o in outs) if minor else outs
    return fn


def work(kernel, kw, head, m=None, n=None, nodes=None):
    """(FLOPs, peak, device bytes) of the instance on the chunk (or at
    (m, n) on ``nodes``): the products the function needs, the Grams on
    their triangle (m n (n + 1) a node) and Q = A Li^T in full (2 m n^2:
    the TPU probe's Li is general), three times for "tf32x3"'s passes, at
    its precision's peak (PEAK_FP64 for "dmma"); each input read once and
    each output written once (node-minor tensors whole tiles)."""
    from ..ops.mxu_probes import NT

    B = head["chunk"] if nodes is None else nodes
    m = head["m"] if m is None else m
    n = head["n"] if n is None else n
    slots = -(-B // NT) * NT
    if kernel == "node_transpose":
        e = m * n if kw["direction"] == "in" else n * n
        return 0.0, PEAK_FP64, 4 * e * (B + slots)
    prec = kw["precision"]
    peak = {"dmma": PEAK_FP64, "tf32x3": PEAK_TF32, "bf16": PEAK_BF16}[prec]
    passes = 3 if prec == "tf32x3" else 1
    gram, q = m * n * (n + 1), 2 * m * n * n
    nodes_io = slots if kw.get("layout") == "minor" else B
    A, sq = m * n * 4, n * n * 4
    flops, nbytes = {"gram_tc": (gram, A + sq), "q_tc": (q, A + sq + A),
                     "gram_q_gram_tc": (2 * gram + q, A + 3 * sq)}[kernel]
    return passes * flops * B, peak, nbytes * nodes_io


def instance_bound(kernel, kw, head, **at):
    flops, peak, nbytes = work(kernel, kw, head, **at)
    return bound(flops, nbytes, peak=peak)


def stage_ms(cuts):
    """The stage-cut times the products would replace, from a
    ``time_cuts`` list at rounds = 2."""
    at = {c["stop"]: c for c in cuts}
    st = {k: at[k]["stage_ms"] for k in ("gram1", "q", "gram2")}
    st["gram1_q_gram2"] = sum(st.values())
    return st


def time_probes(prepared, cuts):
    """Every instance's ms, bound, occupancy, plain and library ms on each
    prepared chunk (``setup`` done), K1_CONFIGS' also at kernel 1's request
    with their launches there, beside the stage cuts (``cuts[i]``: a
    ``time_cuts`` list at rounds = 2 for chunk i) and the unfused route's
    Gram kernels on the same tensors.  These launches are the path
    ``launches`` counts."""
    from ..ops import cholqr as cq
    from ..ops import mxu_probes as mp

    table = []
    for (head, t), chunk_cuts in zip(prepared, cuts):
        row = dict(head, kernels={})
        for kernel, kw in CONFIGS:
            bound_ms, bound_by = instance_bound(kernel, kw, head)
            prec = kw.get("precision", "dmma")
            with mp._full_float32():
                library_ms = ks.best_ms(library_call(kernel, kw, t))
                plain_ms = ks.once_ms(lambda: run(kernel, kw, t, plain=True))
            row["kernels"][label(kernel, kw)] = {
                "kernel": kernel, **kw,
                "ms": ks.best_ms(lambda: run(kernel, kw, t)),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "occupancy": mp.occupancy(kernel, head["n"], prec,
                                          kw.get("layout", "major"),
                                          m=head["m"])}
            if (kernel, kw) in K1_CONFIGS:
                request, wrapper = head["k1_request"], getattr(mp, kernel)
                before = wrapper.launches
                row["kernels"][label(kernel, kw)].update(
                    ms_k1=ks.best_ms(lambda: run(kernel, kw, t,
                                                 smem_bytes=request)),
                    launches_k1=wrapper.launches - before,
                    occupancy_k1=mp.occupancy(kernel, head["n"], prec,
                                              kw["layout"], m=head["m"],
                                              smem_bytes=request))
        row["standalone"] = {
            "gram_f32": ks.best_ms(lambda: cq.gram_f32(t["As"])),
            "round2_gram_f32": ks.best_ms(
                lambda: cq.round2_gram_f32(t["As"], t["Li1"]))}
        row["stages"] = stage_ms(chunk_cuts)
        row["verdicts"] = verdicts(row)
        table.append(row)
    return table


def node_err(got, ref, scale):
    """The largest over the nodes of max|got - ref| / max|scale|, per
    node."""
    d = (got - ref).abs().flatten(1).amax(dim=1)
    s = scale.abs().flatten(1).amax(dim=1).clamp_min(1e-30)
    return float((d / s).max()) if len(d) else 0.0


def _scales(A, Li):
    """The operands' magnitude products of the Gram, Q and G2, and the
    float64 results (``exact``) on the same float32 inputs."""
    aA, aQ = A.abs(), A.abs() @ Li.abs().transpose(1, 2)
    A64, Li64 = A.double(), Li.double()
    Q64 = A64 @ Li64.transpose(1, 2)
    scales = {"gram": aA.transpose(1, 2) @ aA, "q": aQ,
              "gram2": aQ.transpose(1, 2) @ aQ}
    exact = {"gram": A64.transpose(1, 2) @ A64, "q": Q64,
             "gram2": Q64.transpose(1, 2) @ Q64}
    return scales, exact


_PARTS = {"gram_tc": ("gram",), "q_tc": ("q",),
          "gram_q_gram_tc": ("gram", "gram2")}


def errors(kernel, kw, got, ref, scales, exact):
    """An instance's outputs (node-major tuples) against its plain
    version's: node_transpose bit for bit (``max_err`` 0 or inf); the
    products per node over their scale (``max_err``) and, as a finding,
    against float64 (``f64_err``)."""
    if kernel == "node_transpose":
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        return {"max_err": 0.0 if same else float("inf"), "tol": 0.0,
                "exact": same,
                "max_abs_err": max(float((a - b).abs().max()) if a.numel()
                                   else 0.0 for a, b in zip(got, ref))}
    parts = _PARTS[kernel]
    return {"max_err": max(node_err(g, r, scales[p])
                           for g, r, p in zip(got, ref, parts)),
            "f64_err": max(node_err(g.double(), exact[p], scales[p])
                           for g, p in zip(got, parts)),
            "tol": TOL,
            "max_abs_err": max(float((g - r).abs().max())
                               for g, r in zip(got, ref))}


def probe_errors(prepared):
    """Each instance against its plain version on each prepared chunk:
    [{label: errors(...) | {"nodes": B}}], K1_CONFIGS' also at the head's
    ``k1_request`` where it has one ("max_err_k1", "f64_err_k1",
    "max_abs_err_k1")."""
    from ..ops.mxu_probes import _full_float32

    out = []
    for head, t in prepared:
        B = head["chunk"]
        scales, exact = _scales(t["As"], t["Li1"])
        errs = {}
        for kernel, kw in CONFIGS:
            with _full_float32():
                ref = major(run(kernel, kw, t, plain=True), kernel, kw, B)
            got = major(run(kernel, kw, t), kernel, kw, B)
            e = errs[label(kernel, kw)] = dict(
                errors(kernel, kw, got, ref, scales, exact), nodes=B)
            if (kernel, kw) in K1_CONFIGS and "k1_request" in head:
                got = major(run(kernel, kw, t, smem_bytes=head["k1_request"]),
                            kernel, kw, B)
                k1 = errors(kernel, kw, got, ref, scales, exact)
                e.update(max_err_k1=k1["max_err"], f64_err_k1=k1["f64_err"],
                         max_abs_err_k1=k1["max_abs_err"])
            del got, ref
        out.append(errs)
        del scales, exact
    return out


def verdicts(row):
    """The TPU probes' verdicts, in their own terms, on the row's times:
      mxu        (mxu_probe.py:18-20) for each float32-true precision: does
                 the round trip (the node-minor Gram, transposes included)
                 land under the CUDA-core Gram (gram_f32's register body)
                 and the gram1 cut; does the composite, node-minor (the
                 probe's) and node-major (kernel 1's form), land under the
                 stages it replaces (the gram1, q and gram2 cuts) and
                 under gram_f32 + round2_gram_f32 standalone;
      precision  the faster float32-true node-major Gram, its error
                 against float64 (within TOL?) and its time over bf16's
                 (errors are merged in later: ``finish_verdicts``);
      gram1      ROADMAP.md section 1 item 1: kernel 1's gram1 stage as the
                 DMMA node-major Gram, on its own and at kernel 1's shared
                 memory, against the gram1 cut and gram_f32."""
    k, sa, st = row["kernels"], row["standalone"], row["stages"]
    unfused = sa["gram_f32"] + sa["round2_gram_f32"]
    mxu = {}
    for p in FLOAT32_TRUE:
        rt = k[label("gram_tc", {"precision": p, "layout": "minor"})]["ms"]
        comp = {lay: k[label("gram_q_gram_tc", {"precision": p,
                                                "layout": lay})]["ms"]
                for lay in ("minor", "major")}
        mxu[p] = {"round_trip_ms": rt,
                  "round_trip_beats_gram_f32": rt < sa["gram_f32"],
                  "round_trip_beats_gram1_cut": rt < st["gram1"],
                  **{f"composite_{lay}_ms": ms for lay, ms in comp.items()},
                  **{f"composite_{lay}_beats_cuts": ms < st["gram1_q_gram2"]
                     for lay, ms in comp.items()},
                  **{f"composite_{lay}_beats_unfused": ms < unfused
                     for lay, ms in comp.items()}}
    gram = {p: k[label("gram_tc", {"precision": p, "layout": "major"})]["ms"]
            for p in ("dmma", "tf32x3", "bf16")}
    faster = min(FLOAT32_TRUE, key=gram.get)
    dmma = k[label("gram_tc", {"precision": "dmma", "layout": "major"})]
    k1_ms = dmma.get("ms_k1", dmma["ms"])
    return {"mxu": dict(mxu, cuts_ms=st["gram1_q_gram2"],
                        unfused_ms=unfused),
            "precision": {"faster": faster, "gram_ms": gram,
                          "over_bf16": gram[faster] / gram["bf16"]},
            "gram1": {"dmma_ms": dmma["ms"], "dmma_k1_ms": k1_ms,
                      "gram1_cut_ms": st["gram1"],
                      "gram_f32_ms": sa["gram_f32"],
                      "k1_beats_gram1_cut": k1_ms < st["gram1"],
                      "k1_beats_gram_f32": k1_ms < sa["gram_f32"]}}


def finish_verdicts(row):
    """The precision verdict's errors, once the row has them."""
    v = row["verdicts"]["precision"]
    for p in ("dmma", "tf32x3", "bf16"):
        r = row["kernels"][label("gram_tc", {"precision": p,
                                             "layout": "major"})]
        v.setdefault("f64_err", {})[p] = r["f64_err"]
    v["faster_within_tol"] = v["f64_err"][v["faster"]] <= TOL


def _pads(t, lo, hi):
    """True when ``t`` is nearer ``hi`` than ``lo``."""
    return abs(hi - t) < abs(t - lo)


def shape_verdicts(sweep):
    """r5_mxu_shapes.py's hypotheses on the sweep's times, per precision
    (DMMA's contraction step is 4 rows, TF32's 8):
      H1  the contraction m pads: 132 rows time nearer 136 than 128; the
          split at 128 against the unsplit 132;
      H2  n pads: 72 columns time nearer 80 than 80's time scaled by the
          work (72 x 73 / (80 x 81)); 128 against 80 beside the work's
          ratio (128 x 129 / (80 x 81))."""
    out = {}
    for p in FLOAT32_TRUE:
        t = {(r["m"], r["n"], r["split"]): r["ms"] for r in sweep
             if r["precision"] == p}
        t132 = t[132, 80, 0]
        w72, w128 = 72 * 73 / (80 * 81), 128 * 129 / (80 * 81)
        out[p] = {
            "H1_m_pads": _pads(t132, t[128, 80, 0], t[136, 80, 0]),
            "split_over_unsplit": t[132, 80, 128] / t132,
            "H2_n72_pads": _pads(t[132, 72, 0], t132 * w72, t132),
            "n72_over_n80": t[132, 72, 0] / t132, "work_72_over_80": w72,
            "n128_over_n80": t[132, 128, 0] / t132, "work_128_over_80": w128,
            "ns_per_node": {f"{m}x{n}" + (f"@{s}" if s else ""): ms * 1e6
                            / SWEEP_NODES for (m, n, s), ms in t.items()}}
    return out


def sweep_shapes(device, nodes=SWEEP_NODES, shapes=SHAPES):
    """The node-minor Gram at each of ``shapes`` on ``nodes`` synthetic
    nodes (standard normal x 0.1, a seeded generator on ``device``), each
    float32-true precision: its ms, bound, registers, launches (counted
    around its timed run) and its error against its plain version and
    against float64, within TOL."""
    from ..ops import mxu_probes as mp

    gen = torch.Generator(device=device).manual_seed(SEED)
    out = []
    for m, n, split in shapes:
        A = torch.randn((nodes, m, n), generator=gen, device=device) * 0.1
        Am = mp.node_transpose(A, "out")
        aA = A.abs()
        scale = aA.transpose(1, 2) @ aA
        A64 = A.double()
        exact = A64.transpose(1, 2) @ A64
        for p in FLOAT32_TRUE:
            kw = {"precision": p, "layout": "minor"}
            name = label("gram_tc", kw)
            before = mp.gram_tc.launches_by[name]
            ms = ks.best_ms(lambda: mp.gram_tc(Am, split=split, **kw))
            launches = mp.gram_tc.launches_by[name] - before
            got = mp.node_transpose_reference(
                mp.gram_tc(Am, split=split, **kw), "in", nodes)
            with mp._full_float32():
                ref = mp.gram_tc_reference(A, p, split)
                plain_ms = ks.once_ms(lambda: mp._minor_call(
                    lambda X: mp.gram_tc_reference(X, p, split), "minor",
                    nodes, Am))
                library_ms = ks.best_ms(
                    lambda: minor_gram_library(Am, split))
            bound_ms, bound_by = instance_bound(
                "gram_tc", kw, {}, m=m, n=n, nodes=nodes)
            out.append({"m": m, "n": n, "split": split, "precision": p,
                        "nodes": nodes,
                        "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "plain_ms": plain_ms, "library_ms": library_ms,
                        "launches": launches,
                        "occupancy": mp.occupancy("gram_tc", n, p, "minor",
                                                  split),
                        "max_err": node_err(got, ref, scale),
                        "f64_err": node_err(got.double(), exact, scale),
                        "max_abs_err": float((got - ref).abs().max()),
                        "tol": TOL})
            del got, ref
        del A, Am, aA, scale, A64, exact
    return out


def report(table, sweep):
    """The table and the sweep as ``#`` lines, then the verdicts."""
    for row in table:
        print(f"# mxu_probes ({row['E']}, {row['F']}) with_neumann="
              f"{row['with_neumann']} chunk={row['chunk']} m={row['m']} "
              f"n={row['n']}", flush=True)
        for name, r in row["kernels"].items():
            occ = r["occupancy"]
            err = (f"{'exact' if r['exact'] else 'DIFFERS'}"
                   if "exact" in r else
                   f"error {r['max_err']:.2e} (tol {r['tol']:.0e}), "
                   f"float64 {r['f64_err']:.2e}") if "max_err" in r else ""
            print(f"#   {name:>28}: {r['ms']:8.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library "
                  f"{r['library_ms']:.4f} ms, plain {r['plain_ms']:.2f} ms;"
                  f" {occ['registers']} registers, {occ['local_bytes']} "
                  f"spill bytes, {occ['smem_bytes']} B shared, "
                  f"{occ['blocks_per_sm']} blocks an SM; {err}", flush=True)
            if "ms_k1" in r:
                occ = r["occupancy_k1"]
                print(f"#   {'at kernel 1':>28}: {r['ms_k1']:8.4f} ms; "
                      f"{occ['smem_bytes']} B shared, {occ['blocks_per_sm']}"
                      f" blocks an SM, {r['launches_k1']} launches"
                      + (f"; error {r['max_err_k1']:.2e}, float64 "
                         f"{r['f64_err_k1']:.2e}" if "max_err_k1" in r
                         else ""), flush=True)
        st, sa = row["stages"], row["standalone"]
        print(f"#   stage cuts: gram1 {st['gram1']:.4f}, q {st['q']:.4f}, "
              f"gram2 {st['gram2']:.4f} (sum {st['gram1_q_gram2']:.4f}) ms;"
              f" gram_f32 {sa['gram_f32']:.4f}, round2_gram_f32 "
              f"{sa['round2_gram_f32']:.4f} ms", flush=True)
        v = row["verdicts"]
        win = {True: "under", False: "over"}
        for p, r in v["mxu"].items():
            if p not in FLOAT32_TRUE:
                continue
            print(f"#   verdict mxu {p}: round trip {r['round_trip_ms']:.4f} "
                  f"ms {win[r['round_trip_beats_gram_f32']]} gram_f32, "
                  f"{win[r['round_trip_beats_gram1_cut']]} the gram1 cut; "
                  + "; ".join(
                      f"composite {lay} {r[f'composite_{lay}_ms']:.4f} ms "
                      f"{win[r[f'composite_{lay}_beats_cuts']]} the cuts "
                      f"({v['mxu']['cuts_ms']:.4f}), "
                      f"{win[r[f'composite_{lay}_beats_unfused']]} gram_f32 "
                      f"+ round2_gram_f32 ({v['mxu']['unfused_ms']:.4f})"
                      for lay in ("minor", "major")), flush=True)
        g1 = v["gram1"]
        print(f"#   verdict gram1: the DMMA node-major Gram {g1['dmma_ms']:.4f}"
              f" ms, {g1['dmma_k1_ms']:.4f} at kernel 1's shared memory "
              f"({win[g1['k1_beats_gram1_cut']]} the gram1 cut "
              f"{g1['gram1_cut_ms']:.4f}, "
              f"{win[g1['k1_beats_gram_f32']]} gram_f32 "
              f"{g1['gram_f32_ms']:.4f})", flush=True)
        pv = v["precision"]
        print(f"#   verdict precision: {pv['faster']} is the faster "
              f"float32-true Gram ({pv['gram_ms'][pv['faster']]:.4f} ms, "
              f"{pv['over_bf16']:.2f}x bf16's {pv['gram_ms']['bf16']:.4f}),"
              f" float64 error {pv['f64_err'][pv['faster']]:.2e} "
              f"({'within' if pv['faster_within_tol'] else 'PAST'} "
              f"{TOL:.0e}); bf16's {pv['f64_err']['bf16']:.2e}", flush=True)
    print(f"# mxu_probes shape sweep: node-minor Gram, "
          f"{sweep[0]['nodes'] if sweep else 0} nodes", flush=True)
    for r in sweep:
        print(f"#   m={r['m']:3d} n={r['n']:3d} split={r['split']:3d} "
              f"{r['precision']:>6}: {r['ms']:8.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['occupancy']['registers']} registers, "
              f"{r['occupancy']['blocks_per_sm']} blocks an SM; error {r['max_err']:.2e}, float64 "
              f"{r['f64_err']:.2e}", flush=True)
    for p, r in shape_verdicts(sweep).items():
        print(f"#   verdict shapes {p}: H1 m {'pads' if r['H1_m_pads'] else 'does not pad'}"
              f" (132 vs 128 / 136), split@128 {r['split_over_unsplit']:.3f}x "
              f"unsplit; H2 n=72 {'pads' if r['H2_n72_pads'] else 'does not pad'}"
              f" ({r['n72_over_n80']:.3f}x n=80, work "
              f"{r['work_72_over_80']:.3f}x), n=128 {r['n128_over_n80']:.3f}x "
              f"n=80 (work {r['work_128_over_80']:.3f}x)", flush=True)


def failed(table, sweep):
    """The instances of a table (at either shared memory request) and a
    sweep past their tolerance."""
    bad = [f"({row['E']}, {row['F']}) {name}{at}: error {r[key]:.3e} > "
           f"{r['tol']:.0e}"
           for row in table for name, r in row["kernels"].items()
           for key, at in (("max_err", ""),
                           ("max_err_k1", " at kernel 1's shared memory"))
           if key in r and not r[key] <= r["tol"]]
    return bad + [f"shape ({r['m']}, {r['n']}, split {r['split']}) "
                  f"{r['precision']}: error {r['max_err']:.3e} > "
                  f"{r['tol']:.0e}" for r in sweep
                  if not r["max_err"] <= r["tol"]]


def unlaunched_k1(table):
    """The K1_CONFIGS instances that did not launch at kernel 1's shared
    memory in the timed run."""
    return [f"({row['E']}, {row['F']}) {label(k, kw)}: no launch at kernel "
            f"1's shared memory" for row in table for k, kw in K1_CONFIGS
            if not row["kernels"][label(k, kw)].get("launches_k1")]


def launch_counts():
    """Each instance's launches ({label: count}) from its wrapper's count
    by instance."""
    from ..ops import mxu_probes as mp

    return {label(kernel, kw): getattr(mp, kernel).launches_by[
        label(kernel, kw)] for kernel, kw in CONFIGS}


def reset_counts():
    from ..ops import mxu_probes as mp

    for w in mp.KERNELS:
        w.launches = 0
        w.launches_by.clear()


def probe(chunks, cuts, sweep_nodes=SWEEP_NODES):
    """The whole probe on ``chunks``: the timed path (its launches counted
    from 0), each instance against its plain version merged into the
    table, then the shape sweep (its launches counted around each timed
    run); returns (table, sweep, launches)."""
    prepared = prepare(chunks)
    setup(prepared)
    reset_counts()
    table = time_probes(prepared, cuts)
    launches = launch_counts()
    for row, errs in zip(table, probe_errors(prepared)):
        for name, e in errs.items():
            row["kernels"][name].update(e)
        finish_verdicts(row)
    device = prepared[0][1]["As"].device
    del prepared
    sweep = sweep_shapes(device, sweep_nodes)
    launches[SHAPES_ANSWER] = sum(r["launches"] for r in sweep)
    return table, sweep, launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=68,
                    help="tetra_mesh size (6 n^3 cells); 68 = 1,886,592")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mxu_probes needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"# card: {card}", flush=True)
    interp, _ = build_problem(args.n)
    chunks = ks.chunk_inputs(interp, np.arange(interp.grid.n_points))
    sweeps = ks.route_sweeps(interp.gls.n_refine, 2)
    cuts = [ks.time_cuts(inp, 2, sweeps) for _, inp, _ in chunks]
    table, sweep, launches = probe(chunks, cuts)
    report(table, sweep)
    print(json.dumps({"mxu_probes": {
        "card": card, "mesh": f"tetra_mesh({args.n})", "reps": ks.REPS,
        "launches": launches, "classes": table, "shapes": sweep,
        "shape_verdicts": shape_verdicts(sweep)}}), flush=True)
    bad = failed(table, sweep) + [f"{k}: no launch" for k, n in
                                  launches.items() if n == 0] + \
        unlaunched_k1(table)
    if bad:
        raise SystemExit("\n".join(bad))


if __name__ == "__main__":
    main()
