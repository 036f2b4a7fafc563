"""The readings the limits of ``correct`` are set from, for one cell, in
one process (its set-up is paid once):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3
        [--control 3] [--rebuilds 8] [--check-nodes 512]

For each seed the cell's own boundary conditions and realizations, the
program's rebuilds through the cell's timed path, and the comparison's
numbers against the plain reference (the lower readings); for the first
``--control`` seeds also the control's numbers (the upper readings): the
reference computed in float32 put in the program's place, or with
``--control-setting name=value`` (a JSON value, set on the Interpolator
as a mix's ``settings`` are) the program's own lower-precision path, such
as ``delivery_f32=true``, on the same realizations and nodes.  One JSON line
a seed, then a summary line: the largest program reading and the smallest
control reading of each number.  Needs the CUDA card; the benchmark's own
runs never run it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402
from benchmark.judge import NAMES  # noqa: E402


def calibrate(argv, device=None, spec=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--rebuilds", type=int, default=8)
    ap.add_argument("--check-nodes", type=int, default=None)
    ap.add_argument("--control-setting", default=None)
    args = ap.parse_args(argv)
    import torch

    spec = spec or harness.load_json(os.path.join(harness.ROOT,
                                                  "BENCHMARK.json"))
    cell, config, params = harness.cell_spec(spec, args.workload)
    if args.check_nodes:
        params["check_nodes"] = args.check_nodes
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("calibrate needs the CUDA card")
        device = "cuda"
    seeds = [int(s) for s in args.seeds.split(",")]
    run = harness.Run(args.workload, seeds[0], 0, False, device, config,
                      params)
    gen = harness.generator(params)(run)
    gen.setup_mesh()
    lows, highs = [], []
    for i, seed in enumerate(seeds):
        gen.setup_seed(seed)
        if i == 0:
            gen.rebuild(0, keep=False)
        t0 = time.perf_counter()
        records = [gen.rebuild(r) for r in range(1, args.rebuilds + 1)]
        t1 = time.perf_counter()
        refs = gen.reference(records)
        t2 = time.perf_counter()
        per = gen.numbers(records, refs)
        low = {n: max(p[n] for p in per) for n in NAMES}
        line = {"seed": seed, "program": low,
                "nodes": sum(len(x["nodes"]) for x in records),
                "n_bad": [x["n_bad"] for x in records],
                "rebuild_s": (t1 - t0) / args.rebuilds,
                "reference_s": t2 - t1}
        lows.append(low)
        if i < args.control and args.control_setting:
            name, value = args.control_setting.split("=", 1)
            before = gen.set(name, json.loads(value))
            ctl = gen.numbers([gen.rebuild(x["r"]) for x in records], refs)
            gen.set(name, before)
        elif i < args.control:
            ctl = gen.control(records, refs)
        if i < args.control:
            high = {n: max(p[n] for p in ctl) for n in NAMES}
            line["control"] = high
            highs.append(high)
        print(json.dumps(line), flush=True)
    summary = {"workload": args.workload, "seeds": len(seeds),
               "lower": {n: max(x[n] for x in lows) for n in NAMES},
               "upper": {n: min(x[n] for x in highs) for n in NAMES}
               if highs else None,
               "seconds": time.perf_counter() - T_START}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    calibrate(sys.argv[1:])
