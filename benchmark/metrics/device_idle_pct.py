"""device_idle_pct: 100 (1 - busy / window) over the traced window,
device delivery."""
from benchmark.readers import idle_pct


def read(run):
    return idle_pct(run, "device_out")
