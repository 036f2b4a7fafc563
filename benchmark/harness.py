"""The benchmark's run: one cell of BENCHMARK.json, one seed, one window.

Everything a cell needs is found by name from its entry in
BENCHMARK.json: the configuration's file (``configs``), the traffic mix
``traffic/<traffic>.json``, whose ``generator`` names the module under
``traffic/`` that drives it, and one reader ``metrics/<metric>.py`` per
metric the cell reports.  A later cell, mix or metric is new files and
entries; no file here changes for it.

A run: set-up (timed from the process's start to the first timed
rebuild: ``setup_s``), the measured window of ``--seconds``, then, after
the window, the device's memory peak, the check that no JAX module was
loaded, the program released and the comparison with the plain reference
(judge.py).  With ``--trace 1`` the window runs under torch.profiler with
the program's phase hook on, and the line carries the per-layer metrics
instead of the end-to-end ones.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

from . import judge

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level modules that may not be loaded in the process that reports
BANNED = ("jax", "jaxlib", "flax", "ninpol_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(spec, workload):
    """The cell's entry, its configuration (loaded from its file) and its
    traffic mix (loaded from traffic/<traffic>.json)."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(os.path.join(ROOT, conf["file"]))
    params = load_json(os.path.join(BENCH, "traffic",
                                    f"{cell['traffic']}.json"))
    return cell, config, params


def limits(config, params):
    """The limits of ``correct``: the configuration's, where the mix
    gives none of its own."""
    return dict(config["limits"], **params.get("limits", {}))


def selected_metrics(spec, workload, trace):
    """The metric entries a cell reports: its end-to-end metrics, or with
    ``trace`` its per-layer metrics (those listing it, or without a
    ``workloads`` key those whose ``moves`` it reports)."""
    def listed(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def reader(name):
    """metrics/<name>.py's ``read(run)``."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def generator(params):
    return importlib.import_module(
        f"benchmark.traffic.{params['generator']}").Generator


class Run:
    """One run's settings and what it measured; the readers' input."""

    def __init__(self, workload, seed, seconds, trace, device, config,
                 params):
        self.workload, self.seed, self.seconds = workload, seed, seconds
        self.trace, self.device = trace, device
        self.config, self.params = config, params
        self.delivery = params.get("delivery")
        self.setup_s = self.grid_build_s = self.window_s = None
        self.records, self.work, self.summary = [], None, None
        self.window_peak_bytes = None


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def card_line():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi not read"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(argv, t_start, device=None, spec=None):
    """A whole run; returns the result line (a dict), or raises.  With
    ``device`` None the run takes the CUDA card the cell asks for and
    stops without a result where there is none; tests pass "cpu"."""
    args = parse(argv)
    spec = spec or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, params = cell_spec(spec, args.workload)
    metrics = selected_metrics(spec, args.workload, args.trace)
    readers = {m["name"]: reader(m["name"]) for m in metrics}
    import torch

    log(f"imports {time.perf_counter() - t_start:.3f} s")
    if device is None:
        if not torch.cuda.is_available() or (
                torch.cuda.device_count() < cell["chips"]):
            raise SystemExit(
                f"no result: the cell needs {cell['chips']} CUDA card(s); "
                f"torch finds {torch.cuda.device_count()}")
        device = "cuda"
        torch.zeros(1, device=device)
        log(f"card reached {time.perf_counter() - t_start:.3f} s")
    r = Run(args.workload, args.seed, args.seconds, bool(args.trace),
            device, config, params)
    lim = limits(config, params)
    gen = generator(params)(r)
    gen.setup()
    gen.sync()
    r.setup_s = time.perf_counter() - t_start
    log(f"set-up {r.setup_s:.3f} s (mesh and program load "
        f"{r.grid_build_s:.3f} s)")

    on_card = device != "cpu"
    if on_card:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    if r.trace:
        from torch.profiler import ProfilerActivity, profile

        from . import trace
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        # the program's phase hook, read on each call
        os.environ["NINPOL_TPU_PHASES"] = "1"
        try:
            with profile(activities=acts) as prof:
                r.records, r.window_s = gen.window(args.seconds)
        finally:
            os.environ.pop("NINPOL_TPU_PHASES", None)
    else:
        r.records, r.window_s = gen.window(args.seconds)
    if on_card:
        r.window_peak_bytes = torch.cuda.max_memory_allocated()
        peak = max(setup_peak, r.window_peak_bytes)
    else:
        peak = 0

    found = sorted({m.split(".")[0] for m in list(sys.modules)}
                   & set(BANNED))
    if found:
        raise SystemExit(f"no result: the process loaded {found}")

    walls = [x["wall_s"] for x in r.records]
    log(f"window {r.window_s:.3f} s, {len(walls)} rebuilds; rebuild s "
        f"p50 {statistics.median(walls):.4f} p90 "
        f"{sorted(walls)[int(0.9 * (len(walls) - 1))]:.4f}; K_r s mean "
        f"{statistics.mean(x['field_s'] for x in r.records):.4f}, "
        f"load_data s mean "
        f"{statistics.mean(x['load_s'] for x in r.records):.4f}, "
        f"delivery s mean "
        f"{statistics.mean(x['deliver_s'] for x in r.records):.4f}; "
        f"n_bad {[x['n_bad'] for x in r.records]}; rebuild s "
        f"{[round(w, 4) for w in walls]}")
    if r.trace:
        r.summary = trace.summarize(trace.load_events(prof),
                                    [x["phases"] for x in r.records])
        del prof

    values = {}
    for m in metrics:
        v = readers[m["name"]](r)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    gen.release()

    t_check = time.perf_counter()
    per = gen.numbers(r.records, gen.reference(r.records))
    numbers = {n: max(p[n] for p in per) for n in per[0]}
    failed = sum(1 for p in per if not all(p[n] <= lim[n] for n in p))
    correct, rows = judge.verdict(numbers, lim)
    correct = correct and failed == 0
    log(f"check {time.perf_counter() - t_check:.3f} s over "
        f"{sum(len(x['nodes']) for x in r.records)} nodes; "
        f"card {card_line() if on_card else 'cpu'}")

    result = {"correct": correct, "attempted": len(r.records),
              "failed": failed, "metrics": values,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(0)
                                  if on_card else "cpu"),
                         "count": cell["chips"],
                         "memory_peak_bytes": int(peak)}}
    if r.trace:
        result["device"]["busy_s"] = r.summary["busy_s"]
        result["device"]["window_s"] = r.summary["window_s"]
        result["breakdown"] = {
            "device_ops": [[k[:100], v]
                           for k, v in r.summary["device_ops"]],
            "idle_gaps": r.summary["idle_gaps"]}
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    result["check"] = {name: {"value": v, "limit": lim}
                       for name, v, lim in rows}
    return result
