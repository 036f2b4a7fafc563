"""rebuild_ms: window wall ms over its rebuilds, device delivery."""
from benchmark.readers import per_rebuild_ms


def read(run):
    return per_rebuild_ms(run, "device_out")
