"""load_data_ms: ms a rebuild in the program's ``load_data`` span
(``Interpolator.load_data``: the K_r, diff_mag and u columns copied into
one fresh host array)."""
from benchmark.recorder import span_ms


def read(run):
    return span_ms(run, "load_data")
