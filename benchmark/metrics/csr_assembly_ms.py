"""csr_assembly_ms: ``interpolate``'s wall less the phase line's
``host_write``: the CSR assembly after the weights reach the host."""
import statistics


def read(run):
    if run.delivery != "csr" or not run.records:
        return None
    if not all("host_write" in x["phases"] for x in run.records):
        return None
    return 1e3 * statistics.mean(x["deliver_s"] - x["phases"]["host_write"]
                                 for x in run.records)
