"""face_build_ms: ms a rebuild in the program's ``face_build`` span, the
numpy work of the GLS face table (K N of both sides, eta, the Neumann
means, the 14-column concatenation)."""
from benchmark.recorder import span_ms


def read(run):
    return span_ms(run, "face_build")
