"""n_bad: nodes a rebuild sent to the exact fallback (the program's
``gls.last_n_bad``), mean over the window's rebuilds."""
import statistics


def read(run):
    counts = [x["n_bad"] for x in run.records]
    if not counts or None in counts:
        return None
    return statistics.mean(counts)
