"""dispatch_ms: ``dispatch`` - ``bucket_plan``, the chunk loop."""
from benchmark.readers import phase_ms


def read(run):
    return phase_ms(run, "dispatch", "bucket_plan")
