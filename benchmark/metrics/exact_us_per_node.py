"""exact_us_per_node: us in the program's ``exact_fallback`` spans over
the nodes it sent there (its ``n_bad`` counter) in the window; None when
no node fell back."""
from benchmark.recorder import snapshot


def read(run):
    snap = snapshot(run)
    n_bad = snap and snap["counters"].get("n_bad")
    total = snap and snap["totals"].get("ninpol_tpu_torch.exact_fallback")
    if not n_bad or not total:
        return None
    return total[1] / 1e3 / n_bad
