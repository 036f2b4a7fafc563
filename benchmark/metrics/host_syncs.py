"""host_syncs: waits of the host for the card a rebuild (the program's
``host_syncs`` counter: each copy from pageable host memory to the card,
each copy to the host, the not-converged count); None on the CPU."""
from benchmark.recorder import counter


def read(run):
    return counter(run, "host_syncs")
