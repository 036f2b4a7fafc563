"""What the metric readers of the program's own spans and counters share
(``ninpol_tpu_torch.utils.tracing``, on while ``NINPOL_TPU_PHASES=1``,
which the harness sets for a traced run's window alone, so the totals are
the window's).  Each reads the recorder's window total over the window's
rebuilds, and None where the program has no recorder or never recorded
the span or counter.  They read on the card alone, as the roofline shares
do: a run on the CPU is the harness's own check of its line, whose set
of metrics stays that of the host clocks and phase marks."""
from __future__ import annotations

PREFIX = "ninpol_tpu_torch."


def snapshot(run):
    if not run.records or run.device == "cpu":
        return None
    try:
        from ninpol_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def span_ms(run, name):
    """Mean ms a rebuild inside the program's span ``name``."""
    snap = snapshot(run)
    total = snap and snap["totals"].get(PREFIX + name)
    if not total:
        return None
    return total[1] / 1e6 / len(run.records)


def counter(run, name, scale=1.0):
    """Counter ``name`` a rebuild, times ``scale``."""
    snap = snapshot(run)
    value = snap and snap["counters"].get(name)
    if value is None:
        return None
    return scale * value / len(run.records)
