"""The comparison that decides ``correct`` must fail what is wrong.

The control (the plain reference in float32 in the program's place; for
the CSR mix the program's own ``delivery_f32`` path) fails every cell's
limits, and a run driven with the timed path broken underneath reads
``correct`` false: a rebuild that returns its state unchanged (the new
permeability ignored), half of the nodes left out, one node's answer
altered where it is produced.  On the CPU, the tiny configuration; the
same readings at the cells' own sizes come from calibrate.py on the card.
"""
import json
import os
import time

import numpy as np
import pytest

import ninpol_tpu_torch
from benchmark import harness, judge
from conftest import ROOT

SPEC = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELL_LIMITS = {w["name"]: harness.limits(*harness.cell_spec(
    SPEC, w["name"])[1:]) for w in SPEC["workloads"]}


def generator(spec, workload, seed=2 ** 31 + 17):
    cell, config, params = harness.cell_spec(spec, workload)
    run = harness.Run(workload, seed, 0, False, "cpu", config, params)
    gen = harness.generator(params)(run)
    gen.setup_mesh()
    gen.setup_seed(seed)
    return gen


def worst(per):
    return {n: max(p[n] for p in per) for n in judge.NAMES}


@pytest.mark.parametrize("seed", [2 ** 31 + 17, 3 * 10 ** 9 + 1, 12345])
def test_float32_control_fails_every_cells_limits(spec, seed):
    gen = generator(spec, "tiny.gls.ensemble", seed)
    records = [gen.rebuild(r) for r in (1, 2)]
    refs = gen.reference(records)
    program = worst(gen.numbers(records, refs))
    control = worst(gen.control(records, refs))
    for cell, limits in CELL_LIMITS.items():
        assert judge.verdict(program, limits)[0], (cell, program)
        assert not judge.verdict(control, limits)[0], (cell, control)


def test_program_float32_delivery_fails_the_csr_limits(spec):
    gen = generator(spec, "tiny.gls.csr")
    records = [gen.rebuild(r) for r in (1, 2)]
    refs = gen.reference(records)
    assert judge.verdict(worst(gen.numbers(records, refs)),
                         CELL_LIMITS["tetra68.gls.csr"])[0]
    gen.set("delivery_f32", True)
    low = worst(gen.numbers([gen.rebuild(r) for r in (1, 2)], refs))
    assert not judge.verdict(low, CELL_LIMITS["tetra68.gls.csr"])[0], low


def break_output(fault):
    """A wrapper of Interpolator.prepare_interpolator that breaks what it
    returns, on the device delivery and on the host one."""
    real = ninpol_tpu_torch.Interpolator.prepare_interpolator

    def wrapped(self, method, variable, target_points, device_out=False):
        out = real(self, method, variable, target_points, device_out)
        w = out if device_out else out[0]
        if fault == "half":
            half = len(target_points) // 2
            w[half:] = 0
            if not device_out:
                out[1][half:] = 0
        else:                   # one answer altered where it is produced
            node = len(target_points) // 2
            w[node, 0] += 1e-6
        return out
    return wrapped


def stale_load_data(real):
    """Interpolator.load_data that keeps the cells' data as the mesh
    brought it: every rebuild returns the state it found."""
    def wrapped(self, data, kind):
        if kind != "cells" or "permeability" not in self.variable_to_index[
                "cells"]:
            real(self, data, kind)
    return wrapped


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("workload", ["tiny.gls.ensemble", "tiny.gls.csr"])
def test_broken_timed_path_reads_not_correct(spec, monkeypatch, workload,
                                             fault):
    cls = ninpol_tpu_torch.Interpolator
    if fault == "stale":
        monkeypatch.setattr(cls, "load_data", stale_load_data(cls.load_data))
    else:
        monkeypatch.setattr(cls, "prepare_interpolator", break_output(fault))
    argv = ["--workload", workload, "--seed", str(2 ** 31 + 3),
            "--seconds", "0.3", "--trace", "0"]
    res = json.loads(json.dumps(harness.run(argv, time.perf_counter(),
                                            device="cpu", spec=spec)))
    assert res["correct"] is False
    assert res["failed"] == res["attempted"]
    over = [n for n, c in res["check"].items() if not c["value"] <= c["limit"]]
    assert over, res["check"]


def test_sound_run_reads_correct(spec):
    argv = ["--workload", "tiny.gls.ensemble", "--seed", str(2 ** 31 + 3),
            "--seconds", "0.3", "--trace", "0"]
    res = harness.run(argv, time.perf_counter(), device="cpu", spec=spec)
    assert res["correct"] is True
    assert all(np.isfinite(c["value"]) for c in res["check"].values())
