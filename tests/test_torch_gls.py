"""GLS through the PyTorch port's public Interpolator (on the CPU, where
the solve runs its plain PyTorch version) vs the scipy dgels oracle and
vs ninpol_tpu on the same meshes and data."""
import numpy as np
import pytest
import torch

import ninpol_tpu
import ninpol_tpu_torch
from ninpol_tpu.utils import meshgen
from ninpol_tpu_torch.interop import from_state
from tests.utils.cases import ALHCase, LINCase
from tests.utils.oracle import gls_oracle

TOL = 1e-10          # the reference's parity bar (test_methods.py:63-76)
RNORM_TOL = 1e-11    # the exact-fallback threshold (fallback_tol)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's default of one
    thread per core would oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Setups:
    """One (case, ninpol_tpu interpolator, port interpolator) per mesh,
    built on first use and shared by the tests of this module."""

    def __init__(self):
        self._made = {}

    def __call__(self, fam, n):
        if (fam, n) not in self._made:
            case = ALHCase()
            case.assign_mesh_properties(meshgen.FAMILIES[fam](n), seed=0)
            ref = ninpol_tpu.Interpolator()
            ref.load_mesh(mesh_obj=case.mesh)
            port = ninpol_tpu_torch.Interpolator(device="cpu")
            port.load_mesh(mesh_obj=case.mesh)
            self._made[(fam, n)] = (case, ref, port)
        return self._made[(fam, n)]


@pytest.fixture(scope="module")
def setups():
    return Setups()


def fields(interp, var):
    v2i = interp.variable_to_index
    return (interp.cells_data[v2i["cells"]["permeability"]],
            interp.cells_data[v2i["cells"]["diff_mag"]],
            interp.points_data[v2i["points"][f"neumann_flag_{var}"]].astype(
                np.int64),
            interp.points_data[v2i["points"][f"neumann_{var}"]])


def oracle(interp, var, tp, **kw):
    """gls_oracle on the interpolator's grid and data, kept on the
    interpolator per (data version, variable, targets, options): several
    tests of this module hold the same mesh to it."""
    memo = interp.__dict__.setdefault("_test_oracle_memo", {})
    key = (interp._data_version, var, np.asarray(tp).tobytes(),
           tuple(sorted(kw.items())))
    if key not in memo:
        memo[key] = gls_oracle(interp.grid, tp, *fields(interp, var), **kw)
    return memo[key]


@pytest.mark.parametrize("fam,n", [("hexa", 3), ("tetra", 3), ("mixed", 3)])
def test_gls_matches_oracle_and_reference(setups, fam, n):
    case, ref, port = setups(fam, n)
    tp = np.arange(port.grid.n_points)
    W, NW = port.prepare_interpolator("gls", case.name, tp)
    Wo, NWo, cond = oracle(port, case.name, tp, return_cond=True)
    ok = cond < 1e7      # dgels output at near-singular stencils is noise
    assert ok.sum() > len(tp) // 2
    scale = max(np.abs(Wo[ok]).max(), 1.0)
    assert np.abs(W[ok] - Wo[ok]).max() / scale < TOL
    assert np.abs(NW[ok] - NWo[ok]).max() / scale < TOL
    Wr, NWr = ref.prepare_interpolator("gls", case.name, tp)
    assert np.abs(W - Wr).max() < TOL
    assert np.abs(NW - NWr).max() < TOL


@pytest.mark.parametrize("fam,n", [("prism", 3), ("misc", 3), ("quad", 5),
                                   ("triangle", 5)])
def test_gls_matches_oracle_other_families(fam, n):
    """The remaining families of test_methods.py:63 against dgels.  The 2D
    families' boundary corners are near-singular (masked by cond) and
    most of their nodes take the exact fallback."""
    case = ALHCase()
    case.assign_mesh_properties(meshgen.FAMILIES[fam](n), seed=0)
    port = ninpol_tpu_torch.Interpolator(device="cpu")
    port.load_mesh(mesh_obj=case.mesh)
    tp = np.arange(port.grid.n_points)
    W, NW = port.prepare_interpolator("gls", case.name, tp)
    Wo, NWo, cond = oracle(port, case.name, tp, return_cond=True)
    ok = cond < 1e7
    assert ok.sum() >= 8
    scale = max(np.abs(Wo[ok]).max(), 1.0)
    assert np.abs(W[ok] - Wo[ok]).max() / scale < TOL
    assert np.abs(NW[ok] - NWo[ok]).max() / scale < TOL


@pytest.mark.parametrize("fam", ["hexa", "tetra", "prism"])
def test_gls_linear_exactness(fam):
    """The interpolate() CSR reproduces a linear field (test_accuracy.py:27;
    the reference reaches ~3e-16)."""
    case = LINCase()
    case.assign_mesh_properties(meshgen.FAMILIES[fam](3), seed=0)
    port = ninpol_tpu_torch.Interpolator(device="cpu")
    port.load_mesh(mesh_obj=case.mesh)
    W, _ = port.interpolate(case.name, "gls")
    assert case.evaluate(W) < 1e-12


@pytest.mark.parametrize("fam,n", [("hexa", 3), ("tetra", 3), ("mixed", 3)])
def test_interpolate_csr_matches_reference(setups, fam, n):
    """interpolate(): the Neumann weight is added to every entry of its
    row and explicit zeros are eliminated, exactly as ninpol_tpu does."""
    case, ref, port = setups(fam, n)
    M, neu = port.interpolate(case.name, "gls")
    Mr, neur = ref.interpolate(case.name, "gls")
    assert M.shape == Mr.shape == (port.grid.n_points, port.grid.n_elems)
    np.testing.assert_array_equal(M.indptr, Mr.indptr)
    np.testing.assert_array_equal(M.indices, Mr.indices)
    assert np.abs(M.data - Mr.data).max() < TOL
    assert np.abs(neu - neur).max() < TOL


def test_dirichlet_rows_are_zero(setups):
    case, _, port = setups("hexa", 3)
    _, _, nflag, _ = fields(port, case.name)
    tp = np.arange(port.grid.n_points)
    W, NW = port.prepare_interpolator("gls", case.name, tp)
    dirichlet = port.grid.boundary_points.astype(bool) & (nflag == 0)
    assert dirichlet.any()
    assert np.abs(W[dirichlet]).max() == 0.0
    assert np.abs(NW[dirichlet]).max() == 0.0


def test_subset_targets(setups):
    case, ref, port = setups("hexa", 3)
    tp = np.arange(port.grid.n_points)
    subset = tp[::3]
    Wfull, _ = port.prepare_interpolator("gls", case.name, tp)
    Wsub, _ = port.prepare_interpolator("gls", case.name, subset)
    assert np.abs(Wsub - Wfull[::3]).max() < 1e-12
    M, _ = port.interpolate(case.name, "gls", subset)
    Mr, _ = ref.interpolate(case.name, "gls", subset)
    np.testing.assert_array_equal(M.indptr, Mr.indptr)
    np.testing.assert_array_equal(M.indices, Mr.indices)
    assert np.abs(M.data - Mr.data).max() < TOL


def test_all_dirichlet_subset_returns_zero_rows(setups):
    case, _, port = setups("hexa", 3)
    _, _, nflag, _ = fields(port, case.name)
    dirichlet = np.nonzero(port.grid.boundary_points.astype(bool)
                           & (nflag == 0))[0][:8]
    W, NW = port.prepare_interpolator("gls", case.name, dirichlet)
    assert np.abs(W).max() == 0.0 and np.abs(NW).max() == 0.0
    wd = port.prepare_interpolator("gls", case.name, dirichlet,
                                   device_out=True)
    assert wd.shape == (len(dirichlet), W.shape[1] + 1)
    assert wd.abs().max().item() == 0.0


def test_neumann_compat_false(setups):
    """neumann_compat=False returns the true Neumann-column weight; the
    default (the reference quirk) returns the last cell weight."""
    case, _, port = setups("hexa", 3)
    _, _, nflag, _ = fields(port, case.name)
    tp = np.arange(port.grid.n_points)
    W, NWc = port.prepare_interpolator("gls", case.name, tp)
    port.gls.neumann_compat = False
    try:
        W2, NWt = port.prepare_interpolator("gls", case.name, tp)
    finally:
        port.gls.neumann_compat = True
    assert np.abs(W - W2).max() < 1e-12
    neu = nflag[tp].astype(bool) & (np.abs(NWc) > 0)
    assert neu.any()
    counts = np.diff(port.grid.esup_ptr)[tp]
    last_w = W[np.arange(len(tp)), counts - 1]
    assert np.abs(NWc[neu] - last_w[neu]).max() < 1e-12
    assert np.abs(NWt[neu] - NWc[neu]).max() > 1e-8
    _, NWo = oracle(port, case.name, tp, neumann_compat=False)
    assert np.abs(NWt - NWo).max() < TOL


def test_asymmetric_permeability(setups):
    """The flux vectors are K @ N, not K^T @ N (gls.pyx:320-321): with a
    non-symmetric K the port still matches the oracle and ninpol_tpu."""
    case, ref, port = setups("tetra", 3)
    g = port.grid
    rng = np.random.default_rng(7)
    K = np.tile(np.eye(3), (g.n_elems, 1, 1)) * 2.0
    skew = rng.standard_normal((g.n_elems, 3, 3))
    K = (K + 0.3 * (skew - np.swapaxes(skew, 1, 2))).reshape(-1, 9)
    dmag = port.compute_diffusion_magnitude(K)
    a = ninpol_tpu_torch.Interpolator(device="cpu")
    a.load_mesh(mesh_obj=case.mesh)
    a.load_data({"permeability": K, "diff_mag": dmag}, "cells")
    r = ninpol_tpu.Interpolator()
    r.load_mesh(mesh_obj=case.mesh)
    r.load_data({"permeability": K, "diff_mag": dmag}, "cells")
    tp = np.arange(g.n_points)
    W, NW = a.prepare_interpolator("gls", case.name, tp)
    Wo, NWo, cond = oracle(a, case.name, tp, return_cond=True)
    ok = cond < 1e7
    scale = max(np.abs(Wo[ok]).max(), 1.0)
    assert np.abs(W[ok] - Wo[ok]).max() / scale < TOL
    assert np.abs(NW[ok] - NWo[ok]).max() / scale < TOL
    Wr, NWr = r.prepare_interpolator("gls", case.name, tp)
    assert np.abs(W - Wr).max() < TOL and np.abs(NW - NWr).max() < TOL


def test_fallback_storm_equals_exact(setups):
    """fallback_tol = 0 sends every solved node through the rnorm ->
    exact float64 re-solve; host and device_out results must equal a
    pure exact=True run bit for bit, and the exact path matches dgels."""
    case, _, port = setups("tetra", 3)
    tp = np.arange(port.grid.n_points)
    port.gls.exact = True
    try:
        We, NWe = port.prepare_interpolator("gls", case.name, tp)
        n_solved = port.gls.last_n_bad
    finally:
        port.gls.exact = False
    Wo, NWo = oracle(port, case.name, tp)
    assert np.abs(We - Wo).max() < 1e-11
    assert np.abs(NWe - NWo).max() < 1e-11
    port.gls.fallback_tol = 0.0
    try:
        Wf, NWf = port.prepare_interpolator("gls", case.name, tp)
        assert port.gls.last_n_bad == n_solved > 0
        wd = port.prepare_interpolator("gls", case.name, tp,
                                       device_out=True).numpy()
    finally:
        port.gls.fallback_tol = 1e-11
    assert np.abs(We - Wf).max() == 0.0
    assert np.abs(NWe - NWf).max() == 0.0
    assert np.abs(wd[:, :We.shape[1]] - We).max() == 0.0
    assert np.abs(wd[:, -1] - NWe).max() == 0.0


def test_device_out_is_a_tensor_on_the_device(setups):
    case, _, port = setups("tetra", 3)
    tp = np.arange(port.grid.n_points)
    W, NW = port.prepare_interpolator("gls", case.name, tp)
    wd = port.prepare_interpolator("gls", case.name, tp, device_out=True)
    assert isinstance(wd, torch.Tensor) and wd.dtype == torch.float64
    assert wd.device == port.device_grid.device
    np.testing.assert_array_equal(wd[:, :-1].numpy(), W)
    np.testing.assert_array_equal(wd[:, -1].numpy(), NW)
    assert port.gls.last_n_bad == 0


def test_many_chunk_plan_matches_one_chunk(setups):
    """Classes split into many solve chunks scatter into the same rows
    as one chunk per class (batched float ops may round differently per
    batch size, hence 1e-14 and not bit equality)."""
    case, _, port = setups("tetra", 3)
    tp = np.arange(port.grid.n_points)
    W, NW = port.prepare_interpolator("gls", case.name, tp)
    port.gls.chunk_nodes = 5
    try:
        W2, NW2 = port.prepare_interpolator("gls", case.name, tp)
        classes, _, _ = port.gls.plan(
            port.device_grid, port.cells_data, port.points_data,
            port.variable_to_index, case.name, tp)
    finally:
        port.gls.chunk_nodes = 32768
    assert all(len(c["nodes"]) > c["chunk"] == 5 for c in classes)
    assert np.abs(W - W2).max() < 1e-14 and np.abs(NW - NW2).max() < 1e-14


def test_from_state_matches_mesh_load(setups):
    """interop.from_state builds the port from ninpol_tpu's cache dict
    (grid constructor args + data): same grid, same weights."""
    case, ref, port = setups("mixed", 3)
    state = ref._make_cache(ref.process_mesh(ref.mesh_obj))
    other = from_state(state, device="cpu")
    tp = np.arange(port.grid.n_points)
    W, NW = port.prepare_interpolator("gls", case.name, tp)
    W2, NW2 = other.prepare_interpolator("gls", case.name, tp)
    np.testing.assert_array_equal(W, W2)
    np.testing.assert_array_equal(NW, NW2)


@pytest.mark.parametrize("method", ["nope"])
def test_unported_methods_raise(setups, method):
    case, _, port = setups("hexa", 3)
    with pytest.raises(ValueError, match="not supported"):
        port.interpolate(case.name, method)
    with pytest.raises(ValueError, match="not supported"):
        port.prepare_interpolator(method, case.name, np.arange(4))


@pytest.mark.parametrize("fam,n", [("hexa", 3), ("tetra", 3)])
def test_refined_solver_matches_oracle_and_reference(setups, fam, n):
    """gls.solver = "refined": ninpol_tpu's float32-Householder-
    preconditioned refinement route, against dgels and against
    ninpol_tpu with the same solver, weights and Neumann vector.  On
    these meshes the route converges on its own (its own weights are the
    ones compared, not the exact fallback's)."""
    case, ref, port = setups(fam, n)
    tp = np.arange(port.grid.n_points)
    port.gls.solver = ref.gls.solver = "refined"
    try:
        W, NW = port.prepare_interpolator("gls", case.name, tp)
        Wr, NWr = ref.prepare_interpolator("gls", case.name, tp)
    finally:
        port.gls.solver = ref.gls.solver = "auto"
    assert port.gls.last_n_bad * 10 < len(tp)
    Wo, NWo, cond = oracle(port, case.name, tp, return_cond=True)
    ok = cond < 1e7
    scale = max(np.abs(Wo[ok]).max(), 1.0)
    assert np.abs(W[ok] - Wo[ok]).max() / scale < TOL
    assert np.abs(NW[ok] - NWo[ok]).max() / scale < TOL
    assert np.abs(W - Wr).max() < TOL and np.abs(NW - NWr).max() < TOL


@pytest.mark.parametrize("fam,neumann", [("tetra", True), ("hexa", False)])
def test_refined_solver_matches_reference_solver(setups, fam, neumann):
    """ops/solve.py::solve_normal_refined against ninpol_tpu's
    solve_normal_refined_ops on the same system (one class of the
    "refined" route on a 3-mesh: its float64 A, whose float32 rounding
    both preconditioners read; mul_G in float64; the route's n_refine =
    2), so the solver itself is held, not the weights the exact fallback
    delivers: the same rnorm > 1e-11 set, most nodes in it converged; y
    to 1e-10 of max |y| on them; on every node the two y within the
    larger of the two error estimates, and the estimates of one size (each
    within 30x, their geometric means within 3x: the two float32
    preconditioners round differently, so their last corrections differ
    at first order)."""
    import jax
    import jax.numpy as jnp
    from ninpol_tpu.ops.solve import solve_normal_refined_ops
    from ninpol_tpu_torch._methods.gls import csne_system, gls_gather
    from ninpol_tpu_torch.ops.gls_solve import mul_G
    from ninpol_tpu_torch.ops.solve import solve_normal_refined

    case, _, port = setups(fam, 3)
    dg = port.device_grid
    classes, face_table, nflag = port.gls.plan(
        dg, port.cells_data, port.points_data, port.variable_to_index,
        case.name, np.arange(port.grid.n_points))
    c = next(c for c in classes if c["with_neumann"] == neumann)
    inp, _ = gls_gather(dg, face_table, nflag, torch.as_tensor(c["nodes"]),
                        c["E"], c["F"], neumann, tau_guard="norm")
    A, active = csne_system(**{k: v for k, v in inp.items() if k != "nm"})
    b = torch.zeros(A.shape[::2], dtype=torch.float64)
    b[:, -1] = 1.0
    y, rn = solve_normal_refined(A, b, lambda v: mul_G(A, v), 2)
    y, rn, act = y.numpy(), rn.numpy(), active.numpy()

    def ref_solve(A64, b64):
        return solve_normal_refined_ops(
            A64.astype(jnp.float32), b64,
            lambda v: jnp.einsum("bmn,bm->bn", A64,
                                 jnp.einsum("bmn,bn->bm", A64, v)),
            n_refine=2)

    yr, rr = (np.asarray(x) for x in jax.jit(ref_solve)(
        jnp.asarray(A.numpy()), jnp.asarray(b.numpy())))
    assert act.sum() >= 8
    conv = act & (rn <= RNORM_TOL)
    np.testing.assert_array_equal(conv, act & (rr <= RNORM_TOL))
    assert 2 * conv.sum() > act.sum()
    assert np.abs(y - yr)[conv].max() / np.abs(yr[conv]).max() < TOL
    gap = np.linalg.norm(y - yr, axis=1) / np.linalg.norm(yr, axis=1)
    assert (gap[act] <= np.maximum(rn, rr)[act]).all()
    ratio = np.log(rn[act] / rr[act])
    assert np.abs(ratio).max() < np.log(30.0)
    assert abs(ratio.mean()) < np.log(3.0)
    # inactive nodes: zero in both
    assert not y[~act].any() and not yr[~act].any()


def test_other_solver_names_run_the_refined_route(setups, monkeypatch):
    """Every solver name but "auto", "cholqr" and "pallas" is the
    "refined" route, as in ninpol_tpu (gls.py:706-710): "nope" runs
    gls_solve_refined and gives "refined"'s weights, bit for bit."""
    from ninpol_tpu_torch._methods import gls as port_gls
    case, _, port = setups("tetra", 3)
    tp = np.arange(port.grid.n_points)
    calls = []
    fn = port_gls.gls_solve_refined
    monkeypatch.setattr(port_gls, "gls_solve_refined",
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    try:
        port.gls.solver = "refined"
        W, NW = port.prepare_interpolator("gls", case.name, tp)
        n = len(calls)
        assert n > 0 and port.gls.route() == "refined"
        port.gls.solver = "nope"
        W2, NW2 = port.prepare_interpolator("gls", case.name, tp)
        assert len(calls) == 2 * n and port.gls.route() == "refined"
    finally:
        port.gls.solver = "auto"
    np.testing.assert_array_equal(W, W2)
    np.testing.assert_array_equal(NW, NW2)


@pytest.mark.parametrize("fam,n", [("tetra", 3), ("mixed", 3)])
def test_one_round_preconditioner_matches_oracle(setups, fam, n):
    """precond_rounds = 1 on the fused route (the solve kernel's plain
    version here): the single-round preconditioner, two more sweeps and
    the exact fallback give dgels's weights."""
    case, _, port = setups(fam, n)
    tp = np.arange(port.grid.n_points)
    port.gls.precond_rounds = 1
    try:
        W, NW = port.prepare_interpolator("gls", case.name, tp)
    finally:
        port.gls.precond_rounds = 2
    Wo, NWo, cond = oracle(port, case.name, tp, return_cond=True)
    ok = cond < 1e7
    scale = max(np.abs(Wo[ok]).max(), 1.0)
    assert np.abs(W[ok] - Wo[ok]).max() / scale < TOL
    assert np.abs(NW[ok] - NWo[ok]).max() / scale < TOL
