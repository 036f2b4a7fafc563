"""Kernel 1's input stream on the card: the probe kernels of
ops/input_probes.py, timed beside kernel 1's floor cut.

The counterpart of the repo's TPU probes tools/r5_layout_probe.py and
r5_overlap_probe.py (the sites and what answers each: ``tools.SITES``).
On the route's own inputs: for the first chunk of each stencil class of
the default route's plan (``kernel_stages.chunk_inputs``), the thirteen
inputs of kernel 1 as the route gathers them, and the same bytes packed
once (``input_probes.pack``, outside the timed window) and laid out
node-minor.  Per class it prints:

  each instance's ms (the best of kernel_stages.REPS single launches,
  after a warm-up, with a FLUSH_BYTES buffer written before each, so no
  instance finds its inputs in the 50 MB L2, and the card kept busy while
  the host launches it, ``flushed_ms``), its bound (``problem.bound``
  of the bytes it must move, and of the dummy work's FP32 operations), its
  GB/s and their share of 3.35 TB/s, the library call (``library_call``),
  its plain version's ms, its registers, spills, shared memory and blocks
  an SM, its error against its plain version;
  kernel 1's floor cut on the same chunk, timed the same way;
  the TPU probes' verdicts on these times (``verdicts``).

input_sum runs in each layout at its own shared memory, and "natural"
also at kernel 1's: a request of the largest dynamic shared memory of
kernel 1's launches on the chunks (ops/gls_solve.py::occupancy; the (24,
36) class's on the route), which holds kernel 1's blocks an SM, 2 in
either class (at (12, 24) kernel 1 is held to 2 by its registers, not by
its own, smaller, shared memory).  overlap_probe runs every body under both
schedules, at its own shared memory and at kernel 1's, at the TPU
probe's TPU_ITERS rounds of dummy work and at a count calibrated on the
card (``calibrate``) so that "compute" alone takes about as long as
"trivial".

Run on the card (the kernels are built from csrc/ on first use):

    python -m ninpol_tpu_torch.tools.input_probes [--n 68]

It prints ``#`` lines, then one JSON line ``{"input_probes": ...}``.
Nothing falls back: a kernel that does not build or launch raises, and
one past its tolerance fails the run after that line.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from . import kernel_stages as ks
from .problem import PEAK_BYTES, bound, build_problem

# each record sum against its plain version, per node over the sum of
# the record's magnitudes: another order of the same float64 sums (the
# integers are exact), as kernel_stages.CUT_TOL holds the floor cut's
# checksum; the float32 dummy work per node over Σ_k |x[e, k]| (trivial:
# the record's magnitudes), as it holds the float32 stages
TOL_SUM = ks.CUT_TOL["floor"]
TOL_WORK = ks.CUT_TOL["gram1"]
# written between timed launches: over five times the H100's L2
FLUSH_BYTES = 256 << 20
# then the card spins this many cycles (~1 ms) while the host enqueues the
# start event and the launch: these kernels take tens of microseconds, less
# than a wrapper's Python, so an idle card would time the host too
SPIN_CYCLES = 2_000_000
TPU_ITERS = 60       # r5_overlap_probe.py's dummy work
SEED = 1.0
# overlap verdicts: excess = (indep - max(trivial, compute)) /
# min(trivial, compute) is 0 when the copies hide under the compute and 1
# when they add to it; "overlapped" at most MARGIN, "serial" at least 1 -
# MARGIN, else "partial".  dep costs more than indep past DEP_MARGIN.
# indep faster than compute by more than FOLD_MARGIN means the work
# folded away, and fails the run.
MARGIN = 0.25
DEP_MARGIN = 0.05
FOLD_MARGIN = 0.03
SMEM = ("own", "k1")
ITERS = (TPU_ITERS, "cal")

_LAYOUTS = ("natural", "packed", "wide", "bulk", "multi", "minor")
_BODIES = ("trivial", "indep", "dep", "compute")
_SCHEDULES = ("block", "pipelined")
# (kernel, the instance's arguments) of every instance timed on a chunk
CONFIGS = (*(("input_sum", {"layout": lay, "smem": "own"})
             for lay in _LAYOUTS),
           ("input_sum", {"layout": "natural", "smem": "k1"}),
           *(("overlap_probe", {"body": b, "schedule": s, "smem": m,
                                "iters": it})
             for it in ITERS for s in _SCHEDULES for m in SMEM
             for b in _BODIES))
# the TPU site each instance answers (tools.SITES' "by")
_ANSWERS = {"natural": "input_sum (natural)", "packed": "input_sum (packed)",
            "wide": "input_sum (wide, bulk)", "bulk": "input_sum (wide, bulk)",
            "multi": "input_sum (multi, minor)",
            "minor": "input_sum (multi, minor)"}


def label(kernel, kw):
    """An instance's name (``input_probes.instance`` of all its
    arguments)."""
    from ..ops.input_probes import instance

    return instance(kernel, **kw)


def answer(kernel, kw):
    """The name under which ``tools.SITES`` lists the instance's site."""
    return _ANSWERS[kw["layout"]] if kernel == "input_sum" else kernel


def flushed_ms(fn, flush):
    """The least device ms of one ``fn()`` over REPS runs, each between two
    CUDA events after ``flush`` is written and SPIN_CYCLES spun, after a
    warm-up run."""
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(ks.REPS)]
    for start, stop in events:
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return min(start.elapsed_time(stop) for start, stop in events)


def k1_smem(head):
    """Kernel 1's dynamic shared memory and blocks an SM at the class."""
    from ..ops import gls_solve as gs

    occ = gs.occupancy(head["E"], head["F"], head["with_neumann"], 2)
    return occ["smem_bytes"], occ["blocks_per_sm"]


def prepare(chunks):
    """The probes' inputs on each chunk (``kernel_stages.chunk_inputs``):
    [(head, tensors)], tensors the thirteen inputs (``inp``), their packed
    records (``rec``) and node-minor records (``minor``), and the sums of
    the records' magnitudes (``scale``)."""
    from ..ops import input_probes as ip

    out = []
    for c, inp, _ in chunks:
        rec = ip.pack(inp)
        B = rec.nodes
        t = {"inp": inp, "rec": rec, "minor": rec.to_minor(),
             "scale": ip.input_sum_reference(rec, absolute=True)}
        head = {"E": c["E"], "F": c["F"], "with_neumann": c["with_neumann"],
                "chunk": B, "stride": rec.stride, "regions": rec.regions,
                "natural_bytes": sum(x.nbytes for x in inp.values()
                                     if x is not None),
                "record_bytes": rec.nbytes}
        out.append((head, t))
    return out


def _smem(head, kw):
    return head["k1_request"] if kw["smem"] == "k1" else 0


def _iters(head, kw):
    return TPU_ITERS if kw["iters"] == TPU_ITERS else head["iters_cal"]


def run(kernel, kw, head, t, plain=False):
    """One call of ``kernel`` with the arguments ``kw`` on the chunk's
    tensors ``t`` (the wrapper, or with ``plain`` its plain version):
    input_sum's (B,) sums, overlap_probe's (w, r)."""
    from ..ops import input_probes as ip

    if kernel == "input_sum":
        lay = kw["layout"]
        x = (t["inp"] if lay == "natural" else
             t["minor"] if lay == "minor" else t["rec"])
        if plain:
            return ip.input_sum_reference(x)
        return ip.input_sum(x, lay, _smem(head, kw))
    args = (t["rec"], kw["body"])
    if plain:
        return ip.overlap_probe_reference(*args, head["E"],
                                          _iters(head, kw), SEED)
    return ip.overlap_probe(*args, kw["schedule"], head["E"],
                            _iters(head, kw), SEED, _smem(head, kw))


def natural_library(inp):
    """The sum of the thirteen per-tensor sums, (B,) float64."""
    B = inp["dk"].shape[0]
    parts = [x.reshape(B, -1).sum(dim=1) for x in inp.values()
             if x is not None]
    return sum(p.double() for p in parts)


def library_call(kernel, kw, t):
    """One PyTorch call over the same bytes, or None: torch.sum(x.view(B,
    -1), 1) of the record's bytes as float64 (not the same function: its
    integers read as float64); for "natural" the sum of the thirteen
    per-tensor sums; overlap_probe has none."""
    if kernel != "input_sum":
        return None
    if kw["layout"] == "natural":
        return lambda: natural_library(t["inp"])
    x = t["rec"].data.view(torch.float64)
    return lambda: torch.sum(x.view(x.shape[0], -1), 1)


def work(kernel, kw, head):
    """(FP32 FLOPs, device bytes) of the instance on the chunk: each input
    read once and each output written once (the thirteen tensors or the
    packed record, with its padding; the sums (B,) float64; w (B, E)
    float32 and r); the dummy work's E x 128 x iters multiply-adds and its
    row sums.  The record sums' float64 adds (one an entry) are left out:
    a thousandth of the bytes' time."""
    B, E = head["chunk"], head["E"]
    if kernel == "input_sum":
        nbytes = (head["natural_bytes"] if kw["layout"] == "natural"
                  else head["record_bytes"])
        return 0.0, nbytes + 8 * B
    body = kw["body"]
    nbytes = (0 if body == "compute" else head["record_bytes"]) \
        + B * (4 * E + 8)
    flops = 0.0 if body == "trivial" else \
        B * E * (2 * 128 * _iters(head, kw) + 127)
    return float(flops), nbytes


def calibrate(head, t, flush):
    """The dummy work's rounds at which "compute" takes about as long as
    "trivial", block schedule at its own shared memory: scaled from
    TPU_ITERS by the ratio of the two times, then once more."""
    from ..ops import input_probes as ip

    rec, E = t["rec"], head["E"]
    trivial = flushed_ms(lambda: ip.overlap_probe(rec, "trivial", "block",
                                                  E, 0), flush)
    iters = TPU_ITERS
    for _ in range(2):
        ms = flushed_ms(lambda: ip.overlap_probe(rec, "compute", "block", E,
                                                 iters), flush)
        iters = max(1, round(iters * trivial / ms))
    return iters


def setup(prepared, flush):
    """Per chunk, outside the timed run: kernel 1's shared memory and
    blocks an SM at the class, the request that stands for them (the
    largest of the chunks'), its floor cut's ms (timed as the instances
    are; the cut stops before the sweeps, so their count is any) and the
    calibrated rounds."""
    from ..ops import gls_solve as gs

    for head, _ in prepared:
        head["k1_smem"], head["k1_blocks_per_sm"] = k1_smem(head)
    request = max(head["k1_smem"] for head, _ in prepared)
    for head, t in prepared:
        head["k1_request"] = request
        head["floor_ms"] = flushed_ms(lambda: gs.gls_solve_stage(
            "floor", **t["inp"], sweeps=3, rounds=2), flush)
        head["iters_cal"] = calibrate(head, t, flush)


def time_probes(prepared, flush):
    """Every instance's ms, bound, GB/s, occupancy, plain and library ms on
    each prepared chunk, and the launches of each instance in its timed
    runs; these launches are the path ``launches`` counts.  Returns
    (table, launches)."""
    from ..ops import input_probes as ip

    table, launches = [], {label(k, kw): 0 for k, kw in CONFIGS}
    for head, t in prepared:
        row = dict(head, kernels={})
        for kernel, kw in CONFIGS:
            name = label(kernel, kw)
            wrapper = getattr(ip, kernel)
            before = wrapper.launches
            ms = flushed_ms(lambda: run(kernel, kw, head, t), flush)
            launches[name] += wrapper.launches - before
            lib = library_call(kernel, kw, t)
            flops, nbytes = work(kernel, kw, head)
            bound_ms, bound_by = bound(flops, nbytes)
            variant = ({"layout": kw["layout"]} if kernel == "input_sum"
                       else {"body": kw["body"], "schedule": kw["schedule"]})
            row["kernels"][name] = {
                "kernel": kernel, **kw, "ms": ms, "bytes": nbytes,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "gb_s": nbytes / ms / 1e6,
                "hbm_share": nbytes / ms / 1e6 / (PEAK_BYTES / 1e9),
                "plain_ms": ks.once_ms(lambda: run(kernel, kw, head, t,
                                                   plain=True)),
                "library_ms": None if lib is None else flushed_ms(lib, flush),
                "occupancy": ip.occupancy(kernel, head["stride"], head["E"],
                                          _smem(head, kw), **variant)}
            if kernel == "overlap_probe":
                row["kernels"][name]["iters_run"] = _iters(head, kw)
        table.append(row)
    return table, launches


def node_err(got, ref, scale):
    """The largest over the nodes of |got - ref| / scale (per node; rows of
    a 2-D output by their largest)."""
    d = (got.double() - ref.double()).abs()
    if d.dim() > 1:
        d = d.amax(dim=1)
    return float((d / scale.clamp_min(1e-300)).max()) if len(d) else 0.0


def errors(kernel, kw, got, ref, head, t):
    """An instance's outputs against its plain version's: the sums (r)
    over the record's magnitudes (TOL_SUM); w over its scale (TOL_WORK)."""
    if kernel == "input_sum":
        return {"max_err": node_err(got, ref, t["scale"]), "tol": TOL_SUM,
                "max_abs_err": float((got - ref).abs().max())}
    from ..ops.input_probes import dummy_work_reference

    (w, r), (w_ref, r_ref) = got, ref
    if kw["body"] == "trivial":
        wscale = t["scale"]
    else:
        seed = (r_ref.float() if kw["body"] == "dep" else
                torch.full_like(r_ref, SEED, dtype=torch.float32))
        wscale = dummy_work_reference(seed, _iters(head, kw), head["E"])[1]
    return {"max_err": node_err(w, w_ref, wscale), "tol": TOL_WORK,
            "r_err": node_err(r, r_ref, t["scale"]), "r_tol": TOL_SUM,
            "max_abs_err": max(float((w - w_ref).abs().max()),
                               float((r - r_ref).abs().max()))}


def probe_errors(prepared):
    """Each instance against its plain version on each prepared chunk:
    [{label: errors(...) | {"nodes": B}}]."""
    out = []
    for head, t in prepared:
        errs = {}
        for kernel, kw in CONFIGS:
            got = run(kernel, kw, head, t)
            ref = run(kernel, kw, head, t, plain=True)
            errs[label(kernel, kw)] = dict(
                errors(kernel, kw, got, ref, head, t), nodes=head["chunk"])
            del got, ref
        out.append(errs)
    return out


def verdicts(row):
    """The TPU probes' verdicts, in their own terms, on the row's times:
      layout   (r5_layout_probe.py:1-9) the fastest layout; "natural" over
               "packed" and over the faster of "wide" and "bulk"; the share
               of the floor cut that the natural loads take, at their own
               shared memory and at kernel 1's, and the rest (the incidence
               search and kernel 1's blocks);
      overlap  (r5_overlap_probe.py:1-13) per schedule, shared memory and
               rounds: ``excess`` and its verdict (MARGIN), the ms the
               inputs add to the work (indep - compute), dep over indep,
               indep not faster than compute; and whether the
               pipelined schedule overlaps where the block schedule at
               kernel 1's shared memory does not; and whether every
               instance at kernel 1's request held kernel 1's blocks an
               SM."""
    k = row["kernels"]
    lay = {lay: k[label("input_sum", {"layout": lay, "smem": "own"})]["ms"]
           for lay in _LAYOUTS}
    nat_k1 = k[label("input_sum", {"layout": "natural", "smem": "k1"})]["ms"]
    floor = row["floor_ms"]
    layout = {"fastest": min(lay, key=lay.get), "ms": lay,
              "natural_k1_ms": nat_k1,
              "natural_over_packed": lay["natural"] / lay["packed"],
              "natural_over_wide_bulk": lay["natural"] / min(lay["wide"],
                                                             lay["bulk"]),
              "floor_ms": floor,
              "natural_share_of_floor": lay["natural"] / floor,
              "natural_k1_share_of_floor": nat_k1 / floor,
              "rest_ms": floor - nat_k1}
    overlap = {}
    for it in ITERS:
        for s in _SCHEDULES:
            for m in SMEM:
                t = {b: k[label("overlap_probe", {
                    "body": b, "schedule": s, "smem": m, "iters": it})]["ms"]
                    for b in _BODIES}
                lo, hi = sorted((t["trivial"], t["compute"]))
                x = (t["indep"] - hi) / lo
                overlap[f"{s},{m},{it}"] = {
                    "ms": t, "excess": x,
                    "added_ms": t["indep"] - t["compute"],
                    "verdict": ("overlapped" if x <= MARGIN else
                                "serial" if x >= 1 - MARGIN else "partial"),
                    "dep_over_indep": t["dep"] / t["indep"],
                    "dep_costs_more": t["dep"] > (1 + DEP_MARGIN) * t["indep"],
                    "indep_not_faster": t["indep"] >= (1 - FOLD_MARGIN)
                    * t["compute"]}
    where = {str(it): {m: overlap[f"pipelined,{m},{it}"]["verdict"]
                       == "overlapped"
                       and overlap[f"block,k1,{it}"]["verdict"] != "overlapped"
                       for m in SMEM} for it in ITERS}
    held = {r["occupancy"]["blocks_per_sm"] for r in k.values()
            if r["smem"] == "k1"} == {row["k1_blocks_per_sm"]}
    return {"layout": layout, "overlap": overlap,
            "pipelined_overlaps_where_block_k1_does_not": where,
            "k1_blocks_held": held}


def report(table):
    """The table as ``#`` lines, then the verdicts."""
    for row in table:
        print(f"# input_probes ({row['E']}, {row['F']}) with_neumann="
              f"{row['with_neumann']} chunk={row['chunk']} record "
              f"{row['stride']} B a node (regions {row['regions']}), natural "
              f"{row['natural_bytes'] / row['chunk']:.0f} B a node; kernel "
              f"1: {row['k1_smem']} B shared, {row['k1_blocks_per_sm']} "
              f"blocks an SM (k1 request {row['k1_request']} B); floor cut "
              f"{row['floor_ms']:.4f} ms; calibrated rounds "
              f"{row['iters_cal']}", flush=True)
        for name, r in row["kernels"].items():
            occ = r["occupancy"]
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms")
            err = ""
            if "max_err" in r:
                err = f"error {r['max_err']:.2e} (tol {r['tol']:.0e})"
                if "r_err" in r:
                    err += f", r {r['r_err']:.2e} (tol {r['r_tol']:.0e})"
            print(f"#   {name:>40}: {r['ms']:8.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"{r['gb_s']:7.1f} GB/s ({100 * r['hbm_share']:.1f}% of "
                  f"HBM), library {lib}, plain {r['plain_ms']:.2f} ms; "
                  f"{occ['registers']} registers, {occ['local_bytes']} spill "
                  f"bytes, {occ['smem_bytes']} B shared, "
                  f"{occ['blocks_per_sm']} blocks an SM; {err}", flush=True)
        v = row["verdicts"]
        lv = v["layout"]
        print(f"#   verdict layout: {lv['fastest']} streams fastest; natural "
              f"{lv['natural_over_packed']:.2f}x packed, "
              f"{lv['natural_over_wide_bulk']:.2f}x the faster of wide and "
              f"bulk; the natural loads take "
              f"{100 * lv['natural_share_of_floor']:.0f}% of the floor cut "
              f"({lv['floor_ms']:.4f} ms), "
              f"{100 * lv['natural_k1_share_of_floor']:.0f}% at kernel 1's "
              f"shared memory; the rest, {lv['rest_ms']:.4f} ms, is the "
              f"incidence search and kernel 1's blocks", flush=True)
        for key, o in v["overlap"].items():
            t = o["ms"]
            print(f"#   verdict overlap {key:>20}: trivial {t['trivial']:.4f}"
                  f", compute {t['compute']:.4f}, indep {t['indep']:.4f}, dep "
                  f"{t['dep']:.4f} ms: excess {o['excess']:.2f} -> "
                  f"{o['verdict']}, the inputs add {o['added_ms']:.4f} ms; "
                  f"dep/indep {o['dep_over_indep']:.3f} ("
                  f"{'costs more' if o['dep_costs_more'] else 'no more'}); "
                  f"indep {'not ' if o['indep_not_faster'] else ''}faster "
                  f"than compute", flush=True)
        print(f"#   kernel 1's blocks an SM "
              f"{'held' if v['k1_blocks_held'] else 'NOT held'} by every "
              f"instance at its request", flush=True)
        for it, by in v["pipelined_overlaps_where_block_k1_does_not"].items():
            said = {True: "overlaps where block does not",
                    False: "does not add an overlap"}
            print(f"#   verdict pipelined vs block at kernel 1's shared "
                  f"memory, rounds {it}: "
                  + ", ".join(f"pipelined ({m}) {said[ok]}"
                              for m, ok in by.items()), flush=True)


def failed(table):
    """The instances of a table past their tolerance, and any indep that
    ran faster than compute alone at TPU_ITERS (folded work)."""
    bad = []
    for row in table:
        head = f"({row['E']}, {row['F']})"
        for name, r in row["kernels"].items():
            if "max_err" in r and not r["max_err"] <= r["tol"]:
                bad.append(f"{head} {name}: error {r['max_err']:.3e} > "
                           f"{r['tol']:.0e}")
            if "r_err" in r and not r["r_err"] <= r["r_tol"]:
                bad.append(f"{head} {name}: r error {r['r_err']:.3e} > "
                           f"{r['r_tol']:.0e}")
        for key, o in row["verdicts"]["overlap"].items():
            if key.endswith(f",{TPU_ITERS}") and not o["indep_not_faster"]:
                bad.append(f"{head} overlap {key}: indep "
                           f"{o['ms']['indep']:.4f} ms runs faster than "
                           f"compute {o['ms']['compute']:.4f} ms")
    return bad


def reset_counts():
    from ..ops import input_probes as ip

    for w in ip.KERNELS:
        w.launches = 0
        w.launches_by.clear()


def probe(chunks):
    """The whole probe on ``chunks``: the set-up (kernel 1's occupancy, its
    floor cut, the calibration),
    then the timed path (its launches counted from 0; the count by
    instance must add up to the wrappers'), then each instance against its
    plain version merged into the table; returns (table, launches)."""
    from ..ops import input_probes as ip

    prepared = prepare(chunks)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                        device=prepared[0][1]["rec"].data.device)
    setup(prepared, flush)
    reset_counts()
    table, launches = time_probes(prepared, flush)
    total = sum(w.launches for w in ip.KERNELS)
    if sum(launches.values()) != total:
        raise RuntimeError(f"launches by instance {sum(launches.values())} "
                           f"!= the wrappers' {total}")
    del flush
    for row, errs in zip(table, probe_errors(prepared)):
        for name, e in errs.items():
            row["kernels"][name].update(e)
        row["verdicts"] = verdicts(row)
    return table, launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=68,
                    help="tetra_mesh size (6 n^3 cells); 68 = 1,886,592")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("input_probes needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"# card: {card}", flush=True)
    interp, _ = build_problem(args.n)
    chunks = ks.chunk_inputs(interp, np.arange(interp.grid.n_points))
    table, launches = probe(chunks)
    report(table)
    print(json.dumps({"input_probes": {
        "card": card, "mesh": f"tetra_mesh({args.n})", "reps": ks.REPS,
        "flush_bytes": FLUSH_BYTES, "launches": launches,
        "classes": table}}), flush=True)
    bad = failed(table) + [f"{k}: no launch" for k, n in launches.items()
                           if n == 0]
    if bad:
        raise SystemExit("\n".join(bad))


if __name__ == "__main__":
    main()
