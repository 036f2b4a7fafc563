"""face_table_ms: the phase line's ``face_cache`` mark, mean a rebuild."""
from benchmark.readers import phase_ms


def read(run):
    return phase_ms(run, "face_cache")
