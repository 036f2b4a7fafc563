"""csr_span_ms: ms a rebuild in the program's ``csr_assembly`` span
(``interpolate`` after its ``prepare_interpolator``: the CSR pattern,
data, ``csr_matrix`` and ``eliminate_zeros``)."""
from benchmark.recorder import span_ms


def read(run):
    return span_ms(run, "csr_assembly")
