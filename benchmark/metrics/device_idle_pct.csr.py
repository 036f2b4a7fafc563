"""device_idle_pct.csr: device_idle_pct of the CSR delivery."""
from benchmark.readers import idle_pct


def read(run):
    return idle_pct(run, "csr")
