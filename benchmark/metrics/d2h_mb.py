"""d2h_mb: 10^6 B a rebuild the program copied from the card to the host
(its ``d2h_bytes`` counter); None on the CPU, where nothing crosses."""
from benchmark.recorder import counter


def read(run):
    return counter(run, "d2h_bytes", 1e-6)
