"""What the metric readers (metrics/<name>.py) share: means over a run's
rebuilds of the program's phase marks and of the trace's range times."""
from __future__ import annotations

import statistics


def phase_ms(run, end, start=None):
    """Mean ms a rebuild from phase mark ``start`` (the delivery's start
    where None) to ``end``; None where the marks were not read."""
    lines = [x["phases"] for x in run.records]
    if not lines or not all(end in p and (start is None or start in p)
                            for p in lines):
        return None
    return 1e3 * statistics.mean(p[end] - (p[start] if start else 0.0)
                                 for p in lines)


def range_ms(run, name):
    """Mean device ms a rebuild of the work launched inside the program's
    range ``name``; None without a trace, or where nothing ran there."""
    if run.summary is None or not run.summary["range_s"].get(name):
        return None
    return 1e3 * run.summary["range_s"][name] / len(run.records)


def per_rebuild_ms(run, delivery):
    """The window's wall ms over its rebuilds, for the mix's delivery."""
    if run.delivery != delivery or not run.records:
        return None
    return 1e3 * run.window_s / len(run.records)


def idle_pct(run, delivery):
    if run.delivery != delivery or run.summary is None:
        return None
    return 100.0 * (1.0 - run.summary["busy_s"] / run.summary["window_s"])
