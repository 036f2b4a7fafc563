"""gather_device_ms: device ms a rebuild of the work launched in the
program's ``ninpol_tpu_torch.gls_gather`` ranges."""
from benchmark.readers import range_ms


def read(run):
    return range_ms(run, "ninpol_tpu_torch.gls_gather")
