"""solve_kernel_ms: device ms a rebuild of the work launched in the
program's ``ninpol_tpu_torch.gls_solve`` ranges (the fused solve)."""
from benchmark.readers import range_ms


def read(run):
    return range_ms(run, "ninpol_tpu_torch.gls_solve")
