"""The port's span-and-counter recorder (ninpol_tpu_torch/utils/tracing.py)
on the CPU, with the port alone: the span tree of a GLS rebuild, the
switch (NINPOL_TPU_PHASES=1) and what its absence costs, the profiler
trace's clock, the counters at the sites where the host and the card
meet, and weights unchanged by the recorder."""
import glob
import json
import re
import resource
import time

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function

import ninpol_tpu_torch
from ninpol_tpu_torch._methods import gls
from ninpol_tpu_torch.utils import meshgen, tracing

P = tracing.PREFIX
LINE = re.compile(r"# gls phases: (.*)")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's default of one
    thread per core would oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Problem:
    """hexa_mesh(3) in the port, and one seeded permeability field after
    another, as a caller rebuilding the weights hands them over."""

    def __init__(self, interp):
        self.interp = interp
        interp.load_mesh(mesh_obj=meshgen.hexa_mesh(3))
        g = interp.grid
        self.rng = np.random.default_rng(0)
        self.u = np.sum(np.asarray(g.centroids) ** 2, axis=1)
        bnd = np.asarray(g.boundary_points).astype(bool)
        flag = (bnd & (self.rng.random(g.n_points) < 0.5)).astype(float)
        interp.load_data({"neumann_u": self.rng.random(g.n_points) * flag,
                          "neumann_flag_u": flag,
                          "dirichlet_flag_u": bnd * (1.0 - flag)},
                         "points")
        self.new_field()

    def new_field(self):
        """A fresh SPD K on every cell, with its diff_mag: load_data and
        compute_diffusion_magnitude, two public calls."""
        n = self.interp.grid.n_elems
        A = self.rng.normal(size=(n, 3, 3))
        K = (A @ A.transpose(0, 2, 1) + np.eye(3)).reshape(n, 9)
        self.interp.load_data(
            {"permeability": K,
             "diff_mag": self.interp.compute_diffusion_magnitude(K),
             "u": self.u}, "cells")


def make_port(**kwargs):
    return Problem(ninpol_tpu_torch.Interpolator(device="cpu", **kwargs))


@pytest.fixture(scope="module")
def problem():
    return make_port()


@pytest.fixture
def off(monkeypatch):
    monkeypatch.delenv("NINPOL_TPU_PHASES", raising=False)
    monkeypatch.delenv("NINPOL_TPU_PROFILE", raising=False)
    return monkeypatch


@pytest.fixture
def on(off):
    """The switch on, and the recorder cleared: a recording that began in
    an earlier test would carry on into this one."""
    off.setenv("NINPOL_TPU_PHASES", "1")
    tracing.reset()
    return off


def rebuild(problem):
    """One rebuild through the upstream's call; the recorder's snapshot
    and the phase line's marks [(name, s)]."""
    problem.new_field()
    problem.interp.interpolate("u", "gls")
    return tracing.snapshot()


def phase_marks(text):
    (line,) = LINE.findall(text)
    return [(name, float(t[:-1])) for name, t in
            (tok.rsplit("=", 1) for tok in line.split(" "))]


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def kids(spans, parent):
    return [s for s in spans if s.parent == parent.sid]


def test_a_rebuild_records_the_span_tree(problem, on, capsys):
    snap = rebuild(problem)
    spans = snap["spans"]
    ids = {s.sid: s for s in spans}
    # every span inside its parent, and of its parent's call
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = ids[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
            assert p.call == s.call
    # one call id a public call: diff_mag (evaluated first), load_data,
    # then interpolate with its prepare_interpolator
    (dm,), (ld,), (prep,), (csr,) = (by_name(spans, P + n) for n in (
        "diff_mag", "load_data", "prepare", "csr_assembly"))
    assert [s.parent for s in (dm, ld, prep, csr)] == [None] * 4
    assert dm.call < ld.call < prep.call == csr.call
    assert {s.call for s in spans} == {dm.call, ld.call, prep.call}
    assert dm.end_ns <= ld.start_ns and prep.end_ns <= csr.start_ns
    # the phases of prepare, in order; the face table's two parts
    n_bad = problem.interp.gls.last_n_bad
    phases = [s.name for s in kids(spans, prep)]
    assert phases == [gls.FACE_TABLE, gls.CLASS_PLAN, gls.DISPATCH,
                      gls.N_BAD_SYNC] + (
        [gls.EXACT_FALLBACK] if n_bad else []) + [gls.HOST_WRITE]
    (table,) = by_name(spans, gls.FACE_TABLE)
    assert [s.name for s in kids(spans, table)] == [gls.FACE_UPLOAD,
                                                     gls.FACE_BUILD]
    (dispatch,) = by_name(spans, gls.DISPATCH)
    chunk = [s.name for s in kids(spans, dispatch)]
    assert chunk and chunk == [gls.GATHER_RANGE, gls.SOLVE_RANGE,
                               gls.EPILOGUE_RANGE] * (len(chunk) // 3)
    # the totals are the spans' sums
    for name, (n, ns) in snap["totals"].items():
        got = by_name(spans, name)
        assert (n, ns) == (len(got), sum(s.end_ns - s.start_ns
                                         for s in got))
    # the phase line: its marks are the phase spans' ends since prepare
    marks = phase_marks(capsys.readouterr().err)
    want = [gls.PHASE_MARKS[s.name].format(n_bad=n_bad)
            for s in kids(spans, prep)]
    assert [m for m, _ in marks] == want
    for (_, t), s in zip(marks, kids(spans, prep)):
        assert t == pytest.approx((s.end_ns - prep.start_ns) / 1e9,
                                  abs=5e-4)


def test_a_fallback_records_its_nodes(problem, on, capsys):
    on.setattr(problem.interp.gls, "fallback_tol", 0.0)
    snap = rebuild(problem)
    n_bad = problem.interp.gls.last_n_bad
    assert n_bad > 0 and snap["counters"]["n_bad"] == n_bad
    (exact,) = by_name(snap["spans"], gls.EXACT_FALLBACK)
    inner = {s.name for s in kids(snap["spans"], exact)}
    assert inner == {gls.GATHER_RANGE, gls.EXACT_RANGE, gls.EPILOGUE_RANGE}
    assert "exact_fallback" in [m for m, _ in
                                phase_marks(capsys.readouterr().err)]


def test_the_switch_off_records_and_costs_nothing(problem, off, capsys):
    rebuild(problem)                     # turns the recorder off
    before = tracing.snapshot()

    def raise_(*args, **kwargs):
        raise AssertionError("called with the recorder off")

    class NoClock:
        monotonic_ns = time_ns = staticmethod(raise_)

    off.setattr(resource, "getrusage", raise_)
    off.setattr(tracing, "time", NoClock)
    # a copy that would count, were the recorder on
    off.setattr(tracing, "crosses", lambda device: True)
    tp = np.arange(problem.interp.grid.n_points)
    rebuild(problem)
    problem.interp.prepare_interpolator("gls", "u", tp, device_out=True)
    problem.interp.prepare_interpolator("idw", "u", tp)
    assert tracing.snapshot() == before
    out = capsys.readouterr()
    assert out.out == "" and out.err == ""


def test_the_recorder_is_off_between_public_calls(problem, on):
    """On only inside public calls; a recording runs on across them until
    a public call finds the switch off."""
    n = rebuild(problem)["totals"][gls.PREPARE][0]
    with tracing.span(P + "outside"):
        tracing.count("outside", 1)
    snap = tracing.snapshot()
    assert P + "outside" not in snap["totals"]
    assert "outside" not in snap["counters"]
    assert rebuild(problem)["totals"][gls.PREPARE][0] == n + 1
    on.delenv("NINPOL_TPU_PHASES")
    kept = rebuild(problem)
    assert kept["totals"][gls.PREPARE][0] == n + 1
    on.setenv("NINPOL_TPU_PHASES", "1")
    assert rebuild(problem)["totals"][gls.PREPARE][0] == 1


def test_spans_share_the_profiler_trace_clock(problem, on, tmp_path):
    """Each span of a profiled call within 1 ms of its own record_function
    event, read as baseTimeNanoseconds + ts.  The profiler converts its
    own clock to the wall clock with a line it fits anew for each trace;
    on a loaded machine that line can miss by tens of ms.  Two anchor
    events, taken on the wall clock just inside the profiled call, measure
    the line, and the events are read through it."""
    on.setenv("NINPOL_TPU_PROFILE", str(tmp_path))
    interp = problem.interp
    prepare, anchors = interp.supported_methods["gls"], []

    def anchored(*args, **kwargs):
        anchors.append(time.time_ns())
        with record_function("anchor.start"):
            pass
        out = prepare(*args, **kwargs)
        anchors.append(time.time_ns())
        with record_function("anchor.end"):
            pass
        return out

    on.setitem(interp.supported_methods, "gls", anchored)
    problem.new_field()
    interp.prepare_interpolator("gls", "u", np.arange(interp.grid.n_points))
    spans = tracing.snapshot()["spans"]
    call = max(s.call for s in spans)
    spans = [s for s in spans if s.call == call]
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    events = [e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"]
    (ea,), (eb,) = ([base + 1e3 * e["ts"] for e in events
                     if e["name"] == name]
                    for name in ("anchor.start", "anchor.end"))
    ta, tb = anchors
    # the profiler's line and the wall clock agree to within 0.1 s
    assert abs(ta - ea) < 1e8 and abs(tb - eb) < 1e8

    def wall(t):
        return ta + (t - ea) * (tb - ta) / (eb - ea)

    names = {s.name for s in spans}
    assert gls.PREPARE in names and gls.SOLVE_RANGE in names
    for name in names:
        mine = sorted((s.start_ns, s.end_ns) for s in by_name(spans, name))
        theirs = sorted((wall(base + 1e3 * e["ts"]),
                         wall(base + 1e3 * (e["ts"] + e["dur"])))
                        for e in events if e["name"] == name)
        assert len(mine) == len(theirs), name
        for (a, b), (c, d) in zip(mine, theirs):
            assert abs(a - c) < 1e6 and abs(b - d) < 1e6, (name, a - c,
                                                           b - d)


def test_no_copy_crosses_on_the_cpu(problem, on):
    snap = rebuild(problem)
    for name in ("h2d_bytes", "d2h_bytes", "host_syncs"):
        assert snap["counters"].get(name, 0) == 0


def chunks(problem, tp, method):
    """The (node count, chunk size) of each stencil class a prepare of
    ``method`` solves."""
    interp = problem.interp
    if method == "gls":
        classes, _, _ = interp.gls.plan(
            interp.device_grid, interp.cells_data, interp.points_data,
            interp.variable_to_index, "u", tp)
        return [(len(c["nodes"]), c["chunk"]) for c in classes]
    flag = interp.get_data("points", tp, "neumann_flag_u")
    active = ~(np.asarray(interp.grid.boundary_points)[tp].astype(bool)
               & (flag == 0))
    return [(len(c["nodes"]), interp.idw.chunk_nodes)
            for c in interp.device_grid.buckets(tp, active)]


@pytest.mark.parametrize("method", ["gls", "idw"])
def test_counters_where_a_card_is_stood_in(problem, on, method):
    """Every copy taken as one to a card: the bytes and waits are the
    accounting's."""
    interp = problem.interp
    g = interp.grid
    tp = np.arange(g.n_points)
    problem.new_field()
    sizes = chunks(problem, tp, method)
    interp.device_grid                   # placed before, outside the count
    on.setattr(tracing, "crosses", lambda device: True)
    interp.prepare_interpolator(method, "u", tp)
    counters = tracing.snapshot()["counters"]
    n_solved = sum(n for n, _ in sizes)
    n_chunks = sum(-(-n // c) for n, c in sizes)
    ncols = g.MX_ELEMENTS_PER_POINT
    # 8 B a node and a position in each chunk; the copy of the rows home
    h2d = 16 * n_solved
    d2h = 8 * len(tp) * ncols
    syncs = 2 * n_chunks + 1
    if method == "gls":
        assert interp.gls.last_n_bad == 0
        # the face table's inputs: K, diff_mag, Neumann values and flags
        h2d += 9 * 8 * g.n_elems + 8 * g.n_elems + 8 * g.n_points \
            + g.n_points
        d2h += 8 * len(tp) + 8                    # the Neumann column, n_bad
        syncs += 5
    assert counters["h2d_bytes"] == h2d
    assert counters["d2h_bytes"] == d2h
    assert counters["host_syncs"] == syncs


def test_face_table_spans_and_rows(problem, on):
    """A rebuild copies the face table's inputs, then builds it, inside
    ``face_table``; on the CPU no row is built by the kernel.  A prepare
    with unchanged data reads the cached table: no copy, no build."""
    snap = rebuild(problem)
    spans = snap["spans"]
    (table,) = by_name(spans, gls.FACE_TABLE)
    assert [s.name for s in kids(spans, table)] == [gls.FACE_UPLOAD,
                                                     gls.FACE_BUILD]
    assert snap["counters"].get("face_rows", 0) == 0
    tracing.reset()
    problem.interp.prepare_interpolator(
        "gls", "u", np.arange(problem.interp.grid.n_points))
    snap = tracing.snapshot()
    (table,) = by_name(snap["spans"], gls.FACE_TABLE)
    assert kids(snap["spans"], table) == []
    assert gls.FACE_UPLOAD not in snap["totals"]
    assert gls.FACE_BUILD not in snap["totals"]
    assert snap["counters"].get("face_rows", 0) == 0


def test_mesh_gathers_are_spans_of_their_chunks(on):
    problem = make_port(mesh=2, shard_geometry=True)
    problem.interp.prepare_interpolator(
        "gls", "u", np.arange(problem.interp.grid.n_points), device_out=True)
    spans = tracing.snapshot()["spans"]
    ids = {s.sid: s for s in spans}
    gathers = by_name(spans, P + "mesh_gather")
    assert gathers
    assert {ids[s.parent].name for s in gathers} <= {gls.GATHER_RANGE}


@pytest.mark.parametrize("method", ["gls", "idw", "ls"])
def test_the_recorder_changes_no_bit(problem, off, method, capsys):
    interp = problem.interp
    problem.new_field()
    tp = np.arange(interp.grid.n_points)
    # every copy counted as one to a card, were the recorder on
    off.setattr(tracing, "crosses", lambda device: True)
    out = []
    for switch in (None, "1"):
        if switch:
            off.setenv("NINPOL_TPU_PHASES", switch)
        W, N = interp.prepare_interpolator(method, "u", tp)
        D = interp.prepare_interpolator(method, "u", tp, device_out=True)
        out.append((W, N, D))
    (W0, N0, D0), (W1, N1, D1) = out
    np.testing.assert_array_equal(W1, W0)
    np.testing.assert_array_equal(N1, N0)
    # the bits (LS is 0/0 on some nodes, and NaN equals no float)
    assert torch.equal(D1.view(torch.int64), D0.view(torch.int64))
    assert tracing.snapshot()["counters"]["h2d_bytes"] > 0
