"""The harness on the CPU: the result line, runs without a card or without
the program, cells, mixes and metrics found by name, and no JAX."""
import ast
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import harness
from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
BANNED = {"jax", "jaxlib", "flax", "ninpol_tpu"}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny_run(spec, workload, trace, seconds=0.5, seed=2 ** 31 + 5):
    argv = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    return harness.run(argv, time.perf_counter(), device="cpu", spec=spec)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", ["tiny.gls.ensemble", "tiny.gls.csr"])
def test_result_line_has_the_contract_keys(spec, workload, trace):
    res = json.loads(json.dumps(tiny_run(spec, workload, trace)))
    keys = list(res)
    assert keys[:5] == KEYS and keys[-1] == "check"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    for name in ("weight_gap", "neumann_gap", "row_sum_gap"):
        c = res["check"][name]
        assert 0 <= c["value"] <= c["limit"]
    want = {m["name"]: m["unit"]
            for m in harness.selected_metrics(spec, workload, trace)}
    assert set(res["metrics"]) <= set(want)
    for name, m in res["metrics"].items():
        assert m["unit"] == want[name] and m["value"] >= 0
    dev = res["device"]
    assert dev["count"] == 1 and "memory_peak_bytes" in dev
    delivery = "rebuild_ms" if "ensemble" in workload else "csr_rebuild_ms"
    if trace:
        # what a CPU run can read: host clocks, phase marks and counters
        readable = ({"grid_build_s", "face_table_ms", "plan_ms",
                     "dispatch_ms", "n_bad", "device_idle_pct"}
                    if "ensemble" in workload else
                    {"grid_build_s", "host_write_ms", "csr_assembly_ms",
                     "device_idle_pct.csr"})
        assert set(res["metrics"]) == readable
        assert dev["window_s"] > 0 and "busy_s" in dev
        assert len(res["breakdown"]["idle_gaps"]) <= 10
        assert len(res["breakdown"]["device_ops"]) <= 10
    else:
        assert set(res["metrics"]) == {"setup_s", delivery}
        assert "breakdown" not in res


def test_per_layer_metrics_follow_their_cells():
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for cell in spec["workloads"]:
        e2e = {m["name"] for m in harness.selected_metrics(
            spec, cell["name"], 0)}
        per = harness.selected_metrics(spec, cell["name"], 1)
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        assert all(m["moves"] in e2e for m in per)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py"))


def test_command_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "tetra68.gls.ensemble", "--seed", "7", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
    assert "no result" in out.stderr


def copy_benchmark(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    return tmp_path


def harness_in(root, argv, spec=None, program=True):
    """harness.run in a fresh process with ``root`` (a copy holding
    BENCHMARK.json and benchmark/) first on the path; the program is
    importable only with ``program``."""
    code = ("import json, sys, time; sys.path[:0] = [sys.argv[1]] + "
            "sys.argv[2:3]; from benchmark import harness; "
            "spec = json.loads(sys.argv[4]) if sys.argv[4] else None; "
            "print(json.dumps(harness.run(json.loads(sys.argv[3]), "
            "time.perf_counter(), device='cpu', spec=spec)))")
    return subprocess.run(
        [sys.executable, "-c", code, str(root), ROOT if program else str(root),
         json.dumps(argv), json.dumps(spec) if spec else ""],
        cwd=str(root), capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=""))


def test_checkout_without_the_program_prints_no_result(tmp_path):
    root = copy_benchmark(tmp_path)
    assert sorted(os.listdir(root)) == ["BENCHMARK.json", "benchmark"]
    out = harness_in(root, ["--workload", "tetra68.gls.ensemble", "--seed",
                            "7", "--seconds", "1", "--trace", "0"],
                     program=False)
    assert out.returncode != 0 and out.stdout == ""


def test_new_config_mix_and_metric_are_found_by_name(tmp_path, spec):
    root = copy_benchmark(tmp_path)
    before = {p: open(os.path.join(BENCH, p), "rb").read()
              for p in ("harness.py", "run.py", "traffic/rebuild.py")}
    conf = json.loads(open(os.path.join(BENCH, "tests/data/tiny.json")).read())
    conf.update(name="small", n=3)
    (root / "benchmark/configs/small.json").write_text(json.dumps(conf))
    mix = json.loads(open(os.path.join(BENCH,
                                       "traffic/gls.ensemble.json")).read())
    mix.update(check_nodes=16, field=dict(mix["field"], sigma=0.5))
    (root / "benchmark/traffic/gls.calm.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/rebuilds.py").write_text(
        "def read(run):\n    return len(run.records)\n")
    spec["configs"].append({"name": "small", "source": "test-only",
                            "file": "benchmark/configs/small.json",
                            "reduced": [], "why": "test-only"})
    spec["workloads"].append({"name": "small.gls.calm", "config": "small",
                              "traffic": "gls.calm", "chips": 1,
                              "why": "test-only"})
    for m in spec["end_to_end"]:
        if m["name"] == "rebuild_ms":
            m["workloads"].append("small.gls.calm")
    spec["per_layer"].append({"name": "rebuilds", "unit": "rebuilds",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "rebuild_ms",
                              "workloads": ["small.gls.calm"]})
    out = harness_in(root, ["--workload", "small.gls.calm", "--seed", "9",
                            "--seconds", "0.3", "--trace", "1"], spec=spec)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["rebuilds"]["value"] == res["attempted"]
    for p, data in before.items():
        assert open(os.path.join(root, "benchmark", p), "rb").read() == data


def test_no_file_imports_jax_or_the_jax_package():
    seen = set()
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                else:
                    continue
                seen |= {n.split(".")[0] for n in names}
    assert not seen & BANNED
    assert "ninpol_tpu_torch" in seen


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla", "flax",
                                  "ninpol_tpu.ops"])
def test_a_loaded_jax_module_stops_the_run(spec, monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, type(sys)(name))
    with pytest.raises(SystemExit, match="no result"):
        tiny_run(spec, "tiny.gls.ensemble", 0, seconds=0.1)


def test_the_run_loads_no_jax_module(spec):
    tiny_run(spec, "tiny.gls.ensemble", 0, seconds=0.1)
    assert not {m.split(".")[0] for m in sys.modules} & BANNED


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["tetra68.gls.ensemble",
                                      "hexa128.gls.ensemble",
                                      "tetra68.gls.csr"])
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 99), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
