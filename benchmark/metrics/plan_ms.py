"""plan_ms: ``bucket_plan`` - ``face_cache``, the class plan."""
from benchmark.readers import phase_ms


def read(run):
    return phase_ms(run, "bucket_plan", "face_cache")
