"""host_write_ms: ``host_write`` less the mark before it (``n_bad_sync``,
or ``exact_fallback`` after a fallback), the copy of the weights to the
host."""
import statistics


def read(run):
    out = []
    for x in run.records:
        p = x["phases"]
        if "host_write" not in p:
            return None
        before = [t for name, t in p.items() if t <= p["host_write"]
                  and name != "host_write"]
        out.append(p["host_write"] - max(before, default=0.0))
    return 1e3 * statistics.mean(out) if out else None
