"""h2d_mb: 10^6 B a rebuild the program copied from the host to the card
(its ``h2d_bytes`` counter); None on the CPU, where nothing crosses."""
from benchmark.recorder import counter


def read(run):
    return counter(run, "h2d_bytes", 1e-6)
