"""csr_rebuild_ms: window wall ms over its rebuilds, CSR delivery."""
from benchmark.readers import per_rebuild_ms


def read(run):
    return per_rebuild_ms(run, "csr")
