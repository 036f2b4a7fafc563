"""diff_mag_ms: ms a rebuild in the program's ``diff_mag`` span
(``Interpolator.compute_diffusion_magnitude``: a 3x3 determinant and
trace a cell)."""
from benchmark.recorder import span_ms


def read(run):
    return span_ms(run, "diff_mag")
