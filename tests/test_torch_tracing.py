"""The port's two tracing hooks against ninpol_tpu's, on the CPU:
NINPOL_TPU_PHASES=1 (one "# gls phases: ..." line to stderr from a GLS
prepare) and NINPOL_TPU_PROFILE=<dir> (one torch.profiler trace a
prepare_interpolator call, with the GLS path's record_function ranges);
and the constructors' positional parameters against ninpol_tpu's."""
import contextlib
import glob
import inspect
import io
import json
import re

import numpy as np
import pytest
import torch

import ninpol_tpu
import ninpol_tpu_torch
from ninpol_tpu._methods.device_grid import DeviceGrid as RefDeviceGrid
from ninpol_tpu.utils import meshgen
from ninpol_tpu_torch._methods import gls
from ninpol_tpu_torch._methods.device_grid import DeviceGrid
from tests.utils.cases import ALHCase

PREFIX = "# gls phases: "
NON_EXACT_RANGES = (gls.GATHER_RANGE, gls.SOLVE_RANGE, gls.EPILOGUE_RANGE)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's default of one
    thread per core would oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """hexa_mesh(3) with ALH data in the port, and the phase line of
    ninpol_tpu's GLS prepare on it (the file's one reference GLS call)."""
    case = ALHCase()
    case.assign_mesh_properties(meshgen.FAMILIES["hexa"](3), seed=0)
    port = ninpol_tpu_torch.Interpolator(device="cpu")
    port.load_mesh(mesh_obj=case.mesh)
    tp = np.arange(port.grid.n_points)
    ref = ninpol_tpu.Interpolator()
    ref.load_mesh(mesh_obj=case.mesh)
    err = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stderr(err):
        mp.setenv("NINPOL_TPU_PHASES", "1")
        ref.prepare_interpolator("gls", case.name, tp)
    return case, port, tp, phases(err.getvalue())


@pytest.fixture
def hooks_off(monkeypatch):
    monkeypatch.delenv("NINPOL_TPU_PHASES", raising=False)
    monkeypatch.delenv("NINPOL_TPU_PROFILE", raising=False)
    return monkeypatch


def phases(text):
    """[(name, seconds)] of the one phase line in ``text``."""
    lines = [ln for ln in text.splitlines() if ln.startswith(PREFIX)]
    assert len(lines) == 1, text
    out = []
    for token in lines[0][len(PREFIX):].split(" "):
        name, t = token.rsplit("=", 1)
        assert re.fullmatch(r"\d+\.\d{3}s", t), token
        out.append((name, float(t[:-1])))
    return out


def n_bad_of(ph):
    (n,) = [int(m.group(1)) for m in (
        re.fullmatch(r"n_bad_sync\(n_bad=(\d+)\)", name) for name, _ in ph)
        if m]
    return n


def expected_names(n_bad, device_out):
    """The port's phase names, in its order."""
    return (["face_cache", "bucket_plan", "dispatch",
             f"n_bad_sync(n_bad={n_bad})"]
            + (["exact_fallback"] if n_bad else [])
            + ([] if device_out else ["host_write"]))


def assert_rising(ph):
    times = [t for _, t in ph]
    assert times == sorted(times), ph


def trace_events(trace_dir):
    """The events of the one *.pt.trace.json the profile hook wrote."""
    (path,) = glob.glob(str(trace_dir / "*.pt.trace.json"))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_phase_line_matches_reference(setup, hooks_off, capsys):
    case, port, tp, ref_ph = setup
    hooks_off.setenv("NINPOL_TPU_PHASES", "1")
    port.prepare_interpolator("gls", case.name, tp)
    ph = phases(capsys.readouterr().err)
    names = [n for n, _ in ph]
    n_bad = n_bad_of(ph)
    assert n_bad == port.gls.last_n_bad == n_bad_of(ref_ph)
    assert names == expected_names(n_bad, device_out=False)
    assert set(names) - {"exact_fallback"} <= {n for n, _ in ref_ph}
    assert_rising(ph)
    assert_rising(ref_ph)


@pytest.mark.parametrize("device_out", [False, True])
def test_phase_line_in_a_fallback_storm(setup, hooks_off, capsys,
                                        device_out):
    case, port, tp, _ = setup
    hooks_off.setenv("NINPOL_TPU_PHASES", "1")
    hooks_off.setattr(port.gls, "fallback_tol", 0.0)
    port.prepare_interpolator("gls", case.name, tp, device_out=device_out)
    ph = phases(capsys.readouterr().err)
    n_bad = n_bad_of(ph)
    assert n_bad == port.gls.last_n_bad > 0
    assert [n for n, _ in ph] == expected_names(n_bad, device_out)
    assert_rising(ph)


@pytest.mark.parametrize("method", ["gls", "idw", "ls"])
def test_hooks_change_no_bit(setup, hooks_off, tmp_path, capsys, method):
    case, port, tp, _ = setup
    W0, N0 = port.prepare_interpolator(method, case.name, tp)
    D0 = port.prepare_interpolator(method, case.name, tp, device_out=True)
    hooks_off.setenv("NINPOL_TPU_PHASES", "1")
    hooks_off.setenv("NINPOL_TPU_PROFILE", str(tmp_path))
    W1, N1 = port.prepare_interpolator(method, case.name, tp)
    D1 = port.prepare_interpolator(method, case.name, tp, device_out=True)
    np.testing.assert_array_equal(W1, W0)
    np.testing.assert_array_equal(N1, N0)
    # the bits (LS is 0/0 on some nodes, and NaN equals no float)
    assert torch.equal(D1.view(torch.int64), D0.view(torch.int64))
    assert len(glob.glob(str(tmp_path / "*.pt.trace.json"))) == 2
    err = capsys.readouterr().err
    assert err.count(PREFIX) == (2 if method == "gls" else 0)


def test_hooks_off_enter_no_profiler(setup, hooks_off, capsys):
    case, port, tp, _ = setup

    def no_profiler(*args, **kwargs):
        raise AssertionError("torch.profiler.profile entered")

    hooks_off.setattr(torch.profiler, "profile", no_profiler)
    for method in ("gls", "idw"):
        port.prepare_interpolator(method, case.name, tp)
        port.prepare_interpolator(method, case.name, tp, device_out=True)
    out = capsys.readouterr()
    assert out.out == "" and out.err == ""


@pytest.mark.parametrize("method", ["gls", "idw"])
def test_profile_hook_writes_one_trace(setup, hooks_off, tmp_path, method):
    case, port, tp, _ = setup
    hooks_off.setenv("NINPOL_TPU_PROFILE", str(tmp_path))
    port.prepare_interpolator(method, case.name, tp, device_out=True)
    names = {e.get("name") for e in trace_events(tmp_path)}
    ranges = {n for n in names if n and n.startswith("ninpol_tpu_torch.gls_")}
    if method == "gls":
        assert ranges == set(NON_EXACT_RANGES)      # n_bad is 0 here
    else:
        assert not ranges


def test_positional_arguments_match_reference(setup):
    case, _, tp, _ = setup
    ref = ninpol_tpu.Interpolator("x", False, False, 2)
    assert ref.mesh.devices.size == 2
    by_position = ninpol_tpu_torch.Interpolator("x", False, False, 2,
                                                device="cpu")
    by_keyword = ninpol_tpu_torch.Interpolator(
        name="x", logging=False, build_edges=False, mesh=2, device="cpu")
    assert by_position.mesh.size == 2
    assert by_position.mesh == by_keyword.mesh
    out = []
    for interp in (by_position, by_keyword):
        interp.load_mesh(mesh_obj=case.mesh)
        out.append(interp.prepare_interpolator("gls", case.name, tp))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])


@pytest.mark.parametrize("ref,port", [
    (ninpol_tpu.Interpolator, ninpol_tpu_torch.Interpolator),
    (RefDeviceGrid, DeviceGrid)], ids=["Interpolator", "DeviceGrid"])
def test_reference_parameters_are_a_positional_prefix(ref, port):
    ref_params = list(inspect.signature(ref.__init__).parameters.values())
    port_params = list(inspect.signature(port.__init__).parameters.values())
    assert [(p.name, p.default, p.kind) for p in ref_params] == [
        (p.name, p.default, p.kind) for p in port_params[:len(ref_params)]]
    assert all(p.kind == p.POSITIONAL_OR_KEYWORD for p in port_params)
