"""Run one cell of BENCHMARK.json on the CUDA card and print its result
line: ``python3 benchmark/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` from the repository's root.  Without a card the run
stops with a non-zero code and prints no result."""
import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache a run writes stays at a fixed place inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
# the checkout's root, not this folder, heads the path: no file here may
# shadow a module of the standard library
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    result = harness.run(sys.argv[1:], T_START)
    print(json.dumps(result), flush=True)
