"""Multi-device interpolation of the PyTorch port (parallel/sharding.py) on
the CPU, mirroring tests/test_sharding.py: ``Interpolator(device="cpu",
mesh=8)`` runs eight logical CPU shards in one process, with the grid
replicated or (``shard_geometry=True``) partitioned, and must match the
port's single-device result, and ninpol_tpu's own ``mesh=8`` run on
conftest's eight virtual CPU devices."""
import jax
import numpy as np
import pytest
import torch

import ninpol_tpu
import ninpol_tpu_torch
import ninpol_tpu_torch._methods.gls as port_gls
import ninpol_tpu_torch._methods.idw as port_idw
from ninpol_tpu.utils import meshgen
from ninpol_tpu_torch._methods.device_grid import GridView
from ninpol_tpu_torch.parallel import (Mesh, PartitionedRows, Replicated,
                                       make_mesh, schedule, sharded_gls,
                                       split_nodes)
from ninpol_tpu_torch.parallel import sharding as sharding_module
from ninpol_tpu_torch.parallel.sharding import as_mesh
from tests.utils.cases import ALHCase

TOL = 1e-11        # mesh vs one device (tests/test_sharding.py's bar)
REF_TOL = 1e-10    # the port vs ninpol_tpu (the port's parity bar)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's default of one
    thread per core would oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Setups:
    """One ALH case per tetra_mesh size and one port Interpolator per
    (size, mesh, shard_geometry), built on first use and shared."""

    def __init__(self):
        self._cases, self._interps = {}, {}

    def case(self, n):
        if n not in self._cases:
            case = ALHCase()
            case.assign_mesh_properties(meshgen.tetra_mesh(n), seed=0)
            self._cases[n] = case
        return self._cases[n]

    def __call__(self, n, mesh=None, shard_geometry=False):
        key = (n, mesh, shard_geometry)
        if key not in self._interps:
            interp = ninpol_tpu_torch.Interpolator(
                device="cpu", mesh=mesh, shard_geometry=shard_geometry)
            if mesh is None and shard_geometry:
                # shard_geometry is dropped without a mesh, as in
                # ninpol_tpu: the unfused route on one device instead
                interp.gls.fused = False
            interp.load_mesh(mesh_obj=self.case(n).mesh)
            self._interps[key] = interp
        return self.case(n), self._interps[key]


@pytest.fixture(scope="module")
def setups():
    return Setups()


def flag(interp, var):
    return interp.points_data[
        interp.variable_to_index["points"][f"neumann_flag_{var}"]]


@pytest.mark.parametrize("shard_geometry", [False, True])
@pytest.mark.parametrize("method", ["gls", "idw", "ls"])
def test_public_api_mesh_matches_single_device(setups, method,
                                               shard_geometry):
    """Every class (interior, Neumann) of every method through
    interpolate() on eight CPU shards, against one device on the same
    route (with shard_geometry=True the unfused route: gls.fused = False
    on one device)."""
    case, single = setups(4, None, shard_geometry)
    _, sharded = setups(4, 8, shard_geometry)
    W1, N1 = single.interpolate(case.name, method)
    W8, N8 = sharded.interpolate(case.name, method)
    assert np.abs((W1 - W8).toarray()).max() < TOL
    assert np.abs(N1 - N8).max() < TOL
    interior = ~single.grid.boundary_points.astype(bool)
    sums = np.asarray(W8.sum(axis=1)).ravel()[interior]
    assert np.abs(sums - 1.0).max() < 1e-9


@pytest.mark.parametrize("solver", ["pallas", "refined"])
def test_mesh_solver_routes_match_single_device(setups, solver):
    """The CSNE and "refined" routes under a replicated mesh."""
    case, single = setups(4)
    _, sharded = setups(4, 8)
    tp = np.arange(single.grid.n_points)
    out = []
    for interp in (single, sharded):
        interp.gls.solver = solver
        try:
            out.append(interp.prepare_interpolator("gls", case.name, tp))
        finally:
            interp.gls.solver = "auto"
    (W1, N1), (W8, N8) = out
    assert np.abs(W1 - W8).max() < TOL
    assert np.abs(N1 - N8).max() < TOL


@pytest.mark.parametrize("shard_geometry", [False, True])
def test_mesh_exact_fallback(setups, shard_geometry):
    """Every node through the exact float64 Householder path, its node
    list split over the shards."""
    case, single = setups(3, None, shard_geometry)
    _, sharded = setups(3, 8, shard_geometry)
    tp = np.arange(single.grid.n_points)
    out = []
    for interp in (single, sharded):
        interp.gls.exact = True
        try:
            out.append(interp.prepare_interpolator("gls", case.name, tp))
        finally:
            interp.gls.exact = False
    (W1, N1), (W8, N8) = out
    assert sharded.gls.last_n_bad == single.gls.last_n_bad > 0
    assert np.abs(W1 - W8).max() < TOL
    assert np.abs(N1 - N8).max() < TOL


@pytest.mark.parametrize("shard_geometry", [False, True])
def test_mesh_matches_ninpol_tpu_mesh(setups, shard_geometry):
    """The port's mesh=8 against ninpol_tpu's mesh=8 (jax.shard_map over
    conftest's eight virtual CPU devices, or GSPMD with partitioned
    geometry), GLS on tetra_mesh(3)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) JAX devices")
    case, port = setups(3, 8, shard_geometry)
    ref = ninpol_tpu.Interpolator(mesh=8, shard_geometry=shard_geometry)
    ref.load_mesh(mesh_obj=case.mesh)
    Wr, Nr = ref.interpolate(case.name, "gls")
    Wp, Np = port.interpolate(case.name, "gls")
    assert np.abs((Wr - Wp).toarray()).max() < REF_TOL
    assert np.abs(Nr - Np).max() < REF_TOL


@pytest.mark.parametrize("shard_geometry", [False, True])
def test_sharded_gls_matches_single_device(setups, shard_geometry):
    """parallel.sharded_gls on the interior and the Neumann class, against
    the single-device prepare() (tests/test_sharding.py's
    test_sharded_matches_single_device); a DeviceGrid placed otherwise
    than asked raises."""
    case, interp = setups(3)
    _, sharded = setups(3, 8, shard_geometry)
    grid, dg = interp.grid, sharded.device_grid
    v2i = interp.variable_to_index
    perm = interp.cells_data[v2i["cells"]["permeability"]]
    dmag = interp.cells_data[v2i["cells"]["diff_mag"]]
    nflag = flag(interp, case.name).astype(np.int32)
    nval = interp.points_data[v2i["points"][f"neumann_{case.name}"]]
    tp = np.arange(grid.n_points)
    W_ref, NW_ref = interp.prepare_interpolator("gls", case.name, tp)
    active = ~(grid.boundary_points.astype(bool) & (nflag == 0))
    with pytest.raises(ValueError, match="placed on"):
        sharded_gls(interp.device_grid, make_mesh(8, device="cpu"),
                    shard_geometry=shard_geometry)
    with pytest.raises(ValueError, match="placed on"):
        sharded_gls(dg, make_mesh(8, device="cpu"),
                    shard_geometry=not shard_geometry)
    run = sharded_gls(dg, make_mesh(8, device="cpu"),
                      shard_geometry=shard_geometry)
    is_neu = nflag != 0
    for mask, wneu in ((active & ~is_neu, False), (active & is_neu, True)):
        b = dg.buckets(tp, mask)[0]
        w, wn, err = run(b, perm, dmag, nflag, nval, with_neumann=wneu)
        assert w.device == torch.device("cpu")
        w, wn, err = w.numpy(), wn.numpy(), err.numpy()
        sel = err <= 1e-11
        assert sel.sum() > 0.8 * len(b["nodes"])
        pos = b["pos"][sel]
        k = min(w.shape[1], W_ref.shape[1])
        assert np.abs(w[sel][:, :k] - W_ref[pos][:, :k]).max() < TOL
        assert np.abs(W_ref[pos][:, k:]).max(initial=0.0) == 0.0
        if wneu:
            assert np.abs(wn[sel] - NW_ref[pos]).max() < TOL


PARTITIONED = ("esup2d", "esup_cnt", "fsup2d", "fsup_cnt", "esuf_pair",
               "point_coords", "centroids", "face_table", "neumann_flag")


def placed(interp, case, name):
    """A grid array of the interpolator's DeviceGrid, or its GLS face
    table or Neumann flags (built by one prepare())."""
    dg = interp.device_grid
    if name in GridView.ARRAYS:
        return dg, getattr(dg, name)
    _, face_table, nflag = interp.gls.plan(
        dg, interp.cells_data, interp.points_data, interp.variable_to_index,
        case.name, np.arange(interp.grid.n_points))
    return dg, face_table if name == "face_table" else nflag


@pytest.mark.parametrize("name", PARTITIONED)
def test_sharded_actually_partitions(setups, name):
    """shard_geometry with a mesh partitions every grid array and the
    face table on dim 0: 8 parts of equal length, padded with zero rows
    to a multiple of 8, that hold the array; replicated geometry keeps one
    copy per distinct device (one here: all shards are the CPU)."""
    case, interp = setups(3, 8, True)
    dg, x = placed(interp, case, name)
    assert isinstance(x, PartitionedRows)
    assert len(x.parts) == 8
    assert {p.shape[0] for p in x.parts} == {x.rows}
    assert x.shape[0] == 8 * x.rows and x.shape[0] % 8 == 0
    assert x.n_rows <= x.shape[0] < x.n_rows + 8
    whole = torch.cat(x.parts)
    assert not whole[x.n_rows:].any()
    _, rep = placed(setups(3, 8)[1], case, name)
    assert isinstance(rep, Replicated) and len(rep.copies) == 1
    assert torch.equal(whole[:x.n_rows], rep.on(torch.device("cpu")))
    # each shard holds about an eighth of the replicated bytes
    part = dg.geometry_bytes()
    full = setups(3, 8)[1].device_grid.geometry_bytes()
    assert len(set(full)) == 1 and max(part) * 7 < full[0]


@pytest.mark.parametrize("method,shard_geometry",
                         [("gls", False), ("gls", True), ("idw", False),
                          ("idw", True)])
def test_each_shard_gets_its_split_nodes_share(setups, monkeypatch, method,
                                               shard_geometry):
    """A spy on the gather sees, for every class, shard k receive exactly
    its split_nodes share of the class's nodes, chunk i of every shard
    before chunk i + 1; the shards' nodes add up to the active nodes."""
    case, interp = setups(4, 8, shard_geometry)
    mod, name = (port_gls, "gls_gather") if method == "gls" else \
        (port_idw, "simple_gather")
    calls = []
    real = getattr(mod, name)

    def spy(view, *args, **kwargs):
        nodes = args[2] if method == "gls" else args[0]
        calls.append((view.shard, nodes.numpy().copy()))
        return real(view, *args, **kwargs)

    monkeypatch.setattr(mod, name, spy)
    chunk = 3
    tp = np.arange(interp.grid.n_points)
    dg = interp.device_grid
    if method == "gls":
        monkeypatch.setattr(interp.gls, "chunk_nodes", chunk)
        classes, _, _ = interp.gls.plan(
            dg, interp.cells_data, interp.points_data,
            interp.variable_to_index, case.name, tp)
    else:
        monkeypatch.setattr(interp.idw, "chunk_nodes", chunk)
        active = ~(interp.grid.boundary_points.astype(bool)
                   & (flag(interp, case.name) == 0))
        classes = dg.buckets(tp, active)
    interp.prepare_interpolator(method, case.name, tp)
    seen = []
    for c in classes:
        order = schedule(len(c["nodes"]), 8, chunk)
        mine, calls = calls[:len(order)], calls[len(order):]
        assert [k for k, _ in mine] == [k for k, _, _ in order]
        for k, (lo, hi) in enumerate(split_nodes(len(c["nodes"]), 8)):
            got = [n for s, n in mine if s == k]
            got = np.concatenate(got) if got else np.zeros(0, np.int64)
            assert np.array_equal(got, c["nodes"][lo:hi])
        seen.append(np.concatenate([n for _, n in mine]))
    assert not calls
    seen = np.sort(np.concatenate(seen))
    want = np.sort(np.concatenate([c["nodes"] for c in classes]))
    assert np.array_equal(seen, want) and len(np.unique(seen)) == len(seen)
    if method == "idw":
        assert len(seen) == active.sum()


@pytest.mark.parametrize("size", [8, 3])
@pytest.mark.parametrize("form", ["f64-rows", "i32-cols", "bool-1d",
                                  "f64-2d-index"])
def test_partitioned_rows_getitem_matches_indexing(form, size):
    """PartitionedRows[idx] and [idx, :E] against plain indexing of the
    unpartitioned array, on seeded random indices that include every
    part's first and last rows."""
    rng = np.random.default_rng(7)
    n = 53
    host = {"f64-rows": rng.standard_normal((n, 14)),
            "i32-cols": rng.integers(-5, 1000, (n, 12)).astype(np.int32),
            "bool-1d": rng.random(n) < 0.5,
            "f64-2d-index": rng.standard_normal((n, 3))}[form]
    x = PartitionedRows(host, make_mesh(size, device="cpu"))
    edges = np.concatenate([[k * x.rows, min((k + 1) * x.rows, n) - 1]
                            for k in range(size) if k * x.rows < n])
    idx = np.concatenate([edges, rng.integers(0, n, 40)])
    rng.shuffle(idx)
    if form == "f64-2d-index":
        idx = idx[:len(idx) // 4 * 4].reshape(-1, 4)
    idx_t = torch.as_tensor(idx, dtype=torch.int32 if size == 3 else
                            torch.int64)
    plain = torch.as_tensor(host)
    if form == "i32-cols":
        got, want = x[idx_t, :5], plain[idx_t.long(), :5]
    else:
        got, want = x[idx_t], plain[idx_t.long()]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("ask", ["int-without-card", "int-past-count",
                                 "devices-past-count"])
def test_mesh_of_missing_cards_raises(monkeypatch, caplog, ask):
    """No CPU fallback: a CUDA mesh without a card, or a device list that
    names a card that does not exist, raises before anything runs.  An
    int past the card count takes the cards there are, as ninpol_tpu's
    make_mesh takes the devices it finds, and logs the shortfall."""
    if ask == "int-without-card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CPU fallback"):
            ninpol_tpu_torch.Interpolator(mesh=2)
        return
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if ask == "int-past-count":
        with caplog.at_level("WARNING", logger=sharding_module.__name__):
            assert make_mesh(2) == Mesh(["cuda:0"])
            interp = ninpol_tpu_torch.Interpolator(mesh=2)
        assert interp.mesh == Mesh(["cuda:0"])
        assert interp.device == torch.device("cuda", 0)
        assert [r.levelname for r in caplog.records] == ["WARNING"] * 2
        assert "finds 1; the mesh takes 1" in caplog.records[0].getMessage()
        return
    with pytest.raises(RuntimeError, match="finds 1"):
        ninpol_tpu_torch.Interpolator(mesh=["cuda:0", "cuda:1"])


def test_mesh_helpers():
    """Mesh, as_mesh, split_nodes and schedule."""
    m = Mesh(["cpu", "cpu", "cpu"])
    assert m.size == 3 and m.distinct == (torch.device("cpu"),)
    assert m.primary == torch.device("cpu")
    assert as_mesh(3, device="cpu") == m and as_mesh(m) is m
    assert as_mesh(None) is None
    with pytest.raises(ValueError):
        as_mesh(m, device="cuda")
    with pytest.raises(ValueError):
        Mesh([])
    for n in (0, 1, 7, 8, 9, 100):
        parts = split_nodes(n, m)
        assert parts[0][0] == 0 and parts[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
        assert all(hi - lo <= -(-n // 3) for lo, hi in parts)
        order = schedule(n, m, 2)
        assert sum(hi - lo for _, lo, hi in order) == n
        firsts = [lo for _, lo, _ in order]
        for k in range(3):
            mine = [(lo, hi) for s, lo, hi in order if s == k]
            assert mine == sorted(mine)
            assert all(hi - lo <= 2 for lo, hi in mine)
        assert len(firsts) == len(set(firsts))
    assert [k for k, _, _ in schedule(13, m, 2)] == [0, 1, 2] * 2 + [0, 1]


def test_replicated_mesh_shares_one_copy_per_device(setups):
    """Two logical shards on one device hold one copy of the grid, and the
    results land on the primary device."""
    case = setups.case(3)
    interp = ninpol_tpu_torch.Interpolator(mesh=["cpu", "cpu"])
    interp.load_mesh(mesh_obj=case.mesh)
    dg = interp.device_grid
    assert dg.shards == (torch.device("cpu"),) * 2
    for name in GridView.ARRAYS:
        assert len(getattr(dg, name).copies) == 1
    assert dg.on(0).esup2d is dg.on(1).esup2d
    wd = interp.prepare_interpolator("gls", case.name,
                                     np.arange(interp.grid.n_points),
                                     device_out=True)
    assert wd.device == torch.device("cpu")
    assert interp.gls.last_n_bad == 0
