"""solve_roofline_pct: the least time of a rebuild's GLS work on the card
(yardstick/work.py: dgels FLOPs at the FP64 tensor-core peak, or the
bytes at HBM's) over solve_kernel_ms, in %."""
from benchmark.readers import range_ms
from benchmark.yardstick.work import least_ms


def read(run):
    ms = range_ms(run, "ninpol_tpu_torch.gls_solve")
    if ms is None or run.device == "cpu":
        return None
    return 100.0 * least_ms(*run.work)[0] / ms
