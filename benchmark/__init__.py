"""The benchmark of ninpol_tpu_torch: ``python3 benchmark/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` from the repository's root
(harness.py).  It imports nothing of JAX or of ninpol_tpu."""
