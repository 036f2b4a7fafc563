"""Reading the profiler's trace of a traced run's window.

From the chrome trace torch.profiler exports: the device's busy seconds
(the union of kernels, copies and sets), the device seconds of the work
launched inside each of the program's ``record_function`` ranges (a
kernel belongs to the range its launch call ran in), the device ops that
took most time, and the device's idle gaps by what the host was doing:
the benchmark's own ranges (``bench.*``), the program's ranges, and inside
a delivery the program's phase marks (``NINPOL_TPU_PHASES``).
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile

# the program's record_function ranges around each chunk's steps
PROGRAM_RANGES = ("ninpol_tpu_torch.gls_gather", "ninpol_tpu_torch.gls_solve",
                  "ninpol_tpu_torch.gls_epilogue",
                  "ninpol_tpu_torch.gls_exact")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the program's phase marks, each the end of the step named beside it
PHASE_STEPS = (("face_cache", "face_table"), ("bucket_plan", "class_plan"),
               ("dispatch", "dispatch"), ("n_bad_sync", "n_bad_sync"),
               ("exact_fallback", "exact_fallback"),
               ("host_write", "host_write"))


def load_events(prof):
    """The trace's events, through a file in the run's TMPDIR."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def within(spans, heads, t):
    """The name of the span of ``spans`` (sorted, disjoint (start, end,
    name)) that holds time ``t``, or None."""
    i = bisect.bisect_right(heads, t) - 1
    return spans[i][2] if i >= 0 and t <= spans[i][1] else None


def summarize(events, phase_lines):
    """What the metrics and the result's ``breakdown`` read, from the
    events of a trace whose window is the ``bench.window`` range.
    ``phase_lines`` are the rebuilds' phase marks in order."""
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    win = [e for e in ann if e["name"] == "bench.window"]
    if len(win) != 1:
        raise RuntimeError(f"{len(win)} bench.window ranges in the trace")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and w0 <= e["ts"] <= w1]

    def spans(keep):
        return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ann
                      if keep(e["name"]))

    # the host's activity in three levels, innermost first: the program's
    # ranges, its phase marks inside each delivery, the benchmark's ranges
    levels = [spans(lambda n: n in PROGRAM_RANGES), [],
              spans(lambda n: n.startswith("bench.") and n != "bench.window")]
    delivers = [iv[0] for iv in spans(lambda n: n == "bench.deliver")]
    for t0, marks in zip(delivers, phase_lines):
        prev = 0.0
        for mark, step in PHASE_STEPS:
            if mark in marks:
                levels[1].append((t0 + prev * 1e6, t0 + marks[mark] * 1e6,
                                  f"phase.{step}"))
                prev = marks[mark]
    heads = [[iv[0] for iv in lv] for lv in levels]

    def label(t):
        for lv, hd in zip(levels, heads):
            name = within(lv, hd, t)
            if name:
                return name
        return "bench.other"

    range_s = dict.fromkeys(PROGRAM_RANGES, 0.0)
    ops = {}
    for e in dev:
        ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"] / 1e6
        t = launch.get(e.get("args", {}).get("correlation"))
        name = within(levels[0], heads[0], t) if t is not None else None
        if name:
            range_s[name] += e["dur"] / 1e6
    busy = union((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                 for e in dev)
    busy_s = sum(b - a for a, b in busy) / 1e6

    # idle time by host activity: the window cut at every busy edge and
    # span edge; an idle piece goes to the innermost span around it
    busy_spans = [(a, b, "busy") for a, b in busy]
    busy_heads = [a for a, _ in busy]
    cuts = sorted({w0, w1} | {x for ab in busy for x in ab}
                  | {x for lv in levels for iv in lv for x in iv[:2]
                     if w0 < x < w1})
    gaps = {}
    for a, b in zip(cuts, cuts[1:]):
        if within(busy_spans, busy_heads, (a + b) / 2):
            continue
        name = label((a + b) / 2)
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e6,
            "range_s": range_s, "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}
