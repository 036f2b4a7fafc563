"""A test-only cell beside the real ones: the tiny configuration
(tests/data/tiny.json, tetra_mesh(4)) under each real traffic mix, run on
the CPU with the kernels' plain versions."""
import copy
import json
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
MIXES = {"tiny.gls.ensemble": "gls.ensemble", "tiny.gls.csr": "gls.csr"}


def tiny_spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec = copy.deepcopy(spec)
    spec["configs"].append({"name": "tiny", "source": "test-only",
                            "file": "benchmark/tests/data/tiny.json",
                            "reduced": [], "why": "test-only"})
    for name, mix in MIXES.items():
        spec["workloads"].append({"name": name, "config": "tiny",
                                  "traffic": mix, "chips": 1,
                                  "why": "test-only"})
        real = f"tetra68.{mix}"
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(name)
    return spec


@pytest.fixture
def spec():
    return tiny_spec()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: the cells run the program's "
                    "CUDA kernels, which have no CPU mode")
