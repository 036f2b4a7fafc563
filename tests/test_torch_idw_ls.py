"""IDW and LS through the PyTorch port's public Interpolator (on the CPU)
vs ninpol_tpu (XLA on the CPU) and vs the reference-exact NumPy oracles,
on the same meshes and data (as test_methods.py:31-59 holds ninpol_tpu):
weights, the exact-hit rule, the 2D cuts, and the CSR."""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ninpol_tpu
import ninpol_tpu_torch
from ninpol_tpu._methods.idw import _idw_math
from ninpol_tpu.utils import meshgen
from ninpol_tpu_torch._methods.idw import idw_math, simple_gather
from ninpol_tpu_torch._methods.ls import ls_math
from tests.utils.cases import ALHCase, LINCase
from tests.utils.oracle import idw_oracle, ls_oracle

TOL = 1e-13          # port vs ninpol_tpu, IDW and LS
TOL_ORACLE = 1e-11   # LS vs its oracle (test_methods.py:59)
DENOM_MIN = 1e-8     # LS nodes held to a bound: |denom| > this


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

    def __call__(self, fam, n, Case=ALHCase):
        key = (fam, n, Case)
        if key not in self._made:
            case = Case()
            case.assign_mesh_properties(meshgen.FAMILIES[fam](n), seed=0)
            ref = ninpol_tpu.Interpolator()
            ref.load_mesh(mesh_obj=case.mesh)
            port = ninpol_tpu_torch.Interpolator(device="cpu")
            port.load_mesh(mesh_obj=case.mesh)
            self._made[key] = (case, ref, port)
        return self._made[key]


@pytest.fixture(scope="module")
def setups():
    return Setups()


def neumann_flag(interp, var):
    v2i = interp.variable_to_index["points"]
    return interp.points_data[v2i[f"neumann_flag_{var}"]].astype(np.int64)


def ls_oracle_masked(interp, var, tp):
    """ls_oracle's weights and the nodes held to a bound, |denom| > 1e-8
    (the mask of test_methods.py:50-57: where the reference formula's
    denominator vanishes its output is rounding noise)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        Wo, denom = ls_oracle(interp.grid, tp, neumann_flag(interp, var),
                              return_denom=True)
    return Wo, np.abs(denom) > DENOM_MIN


def port_ls_denom(port, tp):
    """The port's LS denominator over n (ls_oracle's normalisation) at
    every target node, 1 where the system is degenerate."""
    dg = port.device_grid
    E = int(dg.esup_cnt_h[tp].max())
    xv, xc, cv, n_elem = simple_gather(dg, torch.as_tensor(tp), E)
    _, denom, degen = ls_math(xv, xc, cv, n_elem)
    norm = denom / torch.clamp_min(n_elem, 1).to(denom.dtype)
    return torch.where(degen, 1.0, norm).numpy()


@pytest.mark.parametrize("fam", ["hexa", "tetra", "prism", "mixed"])
def test_idw_matches_reference_and_oracle(setups, fam):
    case, ref, port = setups(fam, 3)
    tp = np.arange(port.grid.n_points)
    W, NW = port.prepare_interpolator("idw", case.name, tp)
    Wr, _ = ref.prepare_interpolator("idw", case.name, tp)
    assert W.shape == Wr.shape
    assert np.abs(W - Wr).max() < TOL
    Wo = idw_oracle(port.grid, tp, neumann_flag(port, case.name))
    assert np.abs(W - Wo).max() < TOL
    assert not NW.any()


@pytest.mark.parametrize("fam", ["hexa", "tetra", "prism", "mixed"])
def test_ls_matches_reference_and_oracle(setups, fam):
    """LS on the nodes whose denominator does not vanish; the port's
    |denom| > 1e-8 set is the oracle's (degenerate systems fall back to
    IDW in both, by ninpol_tpu's relative test |D| <= 1e-12 Dabs)."""
    case, ref, port = setups(fam, 3)
    tp = np.arange(port.grid.n_points)
    W, NW = port.prepare_interpolator("ls", case.name, tp)
    Wr, _ = ref.prepare_interpolator("ls", case.name, tp)
    Wo, ok = ls_oracle_masked(port, case.name, tp)
    active = ~(port.grid.boundary_points.astype(bool)
               & (neumann_flag(port, case.name) == 0))
    mine = np.abs(port_ls_denom(port, tp)) > DENOM_MIN
    np.testing.assert_array_equal(mine[active], ok[active])
    assert ok.sum() > len(tp) // 2
    assert np.abs(W - Wr)[ok].max() < TOL
    assert np.abs(W - Wo)[ok].max() < TOL_ORACLE
    assert not NW.any()


def test_quad_mesh_idw_dim_cut_and_ls_guard(setups):
    """A 2D quad mesh: IDW measures distances in x and y only, and LS's
    z moments all vanish, so its Izz = 1 guard keeps the 3x3 system
    regular; both against ninpol_tpu and the oracles."""
    case, ref, port = setups("quad", 5)
    assert port.grid.dim == 2
    tp = np.arange(port.grid.n_points)
    W, _ = port.prepare_interpolator("idw", case.name, tp)
    Wr, _ = ref.prepare_interpolator("idw", case.name, tp)
    assert np.abs(W - Wr).max() < TOL
    assert np.abs(W - idw_oracle(port.grid, tp,
                                 neumann_flag(port, case.name))).max() < TOL
    W, _ = port.prepare_interpolator("ls", case.name, tp)
    Wr, _ = ref.prepare_interpolator("ls", case.name, tp)
    Wo, ok = ls_oracle_masked(port, case.name, tp)
    assert ok.sum() > len(tp) // 2
    assert np.abs(W - Wr)[ok].max() < TOL
    assert np.abs(W - Wo)[ok].max() < TOL_ORACLE


def test_idw_exact_hit_takes_the_first_hit():
    """A node on two centroids at once (squared distance 0 and 1e-16, both
    <= float32(1e-15)) weighs the FIRST of them 1 and every other cell 0;
    a hit on a padding cell is ignored; z is cut in 2D.  Against
    ninpol_tpu's _idw_math on the same stencils (as hi/lo float32 packs,
    exact for these values)."""
    xv = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 5.0], [1.0, 1.0, 1.0]])
    xc = np.array([[[3.0, 0.0, 0.0], [0.0, 0.0, 0.0], [1e-8, 0.0, 0.0],
                    [0.0, 2.0, 0.0]],
                   [[1.0, 0.0, 0.0], [0.0, 0.5, 0.0], [0.0, 0.0, 0.0],
                    [0.0, 0.0, 0.0]],
                   [[2.0, 1.0, 1.0], [1.0, 3.0, 1.0], [1.0, 2.0, 4.0],
                    [1.0, 1.0, 1.0]]])
    cv = np.array([[True] * 4, [True, True, True, True],
                   [True, True, True, False]])
    n_elem = cv.sum(axis=1)
    for dim in (3, 2):
        w = idw_math(torch.as_tensor(xv), torch.as_tensor(xc),
                     torch.as_tensor(cv), torch.as_tensor(n_elem),
                     dim=dim).numpy()

        def pack(a):
            hi = a.astype(np.float32)
            lo = (a - hi).astype(np.float32)
            return jnp.asarray(np.concatenate([hi, lo], axis=-1))

        wr = np.asarray(_idw_math((pack(xv), pack(xc), jnp.asarray(cv),
                                   jnp.asarray(n_elem),
                                   jnp.ones(3, dtype=bool)), dim=dim))
        assert np.abs(w - wr).max() < TOL
        np.testing.assert_array_equal(w[0], [0.0, 1.0, 0.0, 0.0])
        assert not w[2, 3] and w[2, :3].min() > 0
    # node 1 hits cells 2 and 3 in 2D only (z cut), cell 2 first
    np.testing.assert_array_equal(w[1], [0.0, 0.0, 1.0, 0.0])


@pytest.mark.parametrize("method,fam", [("idw", "hexa"), ("idw", "mixed"),
                                        ("ls", "tetra"), ("ls", "mixed")])
def test_interpolate_csr_matches_reference(setups, method, fam):
    """interpolate(): the same CSR as ninpol_tpu's (row pointers, columns,
    explicit zeros eliminated), a zero Neumann vector."""
    case, ref, port = setups(fam, 3)
    M, neu = port.interpolate(case.name, method)
    Mr, neur = ref.interpolate(case.name, method)
    assert M.shape == Mr.shape == (port.grid.n_points, port.grid.n_elems)
    np.testing.assert_array_equal(M.indptr, Mr.indptr)
    np.testing.assert_array_equal(M.indices, Mr.indices)
    if method == "ls":
        _, ok = ls_oracle_masked(port, case.name,
                                 np.arange(port.grid.n_points))
        rows = np.repeat(ok, np.diff(M.indptr))
        assert np.abs(M.data - Mr.data)[rows].max() < TOL
    else:
        assert np.abs(M.data - Mr.data).max() < TOL
    assert not neu.any() and not neur.any()


@pytest.mark.parametrize("method", ["idw", "ls"])
def test_device_out_dirichlet_rows_and_subsets(setups, method):
    """device_out gives the host weights and a zero Neumann column;
    Dirichlet rows are zero; a subset of targets gives the same rows."""
    case, _, port = setups("tetra", 3, LINCase)
    tp = np.arange(port.grid.n_points)
    W, NW = port.prepare_interpolator(method, case.name, tp)
    wd = port.prepare_interpolator(method, case.name, tp, device_out=True)
    assert isinstance(wd, torch.Tensor) and wd.dtype == torch.float64
    np.testing.assert_array_equal(wd[:, :-1].numpy(), W)
    assert not wd[:, -1].any() and not NW.any()
    dirichlet = (port.grid.boundary_points.astype(bool)
                 & (neumann_flag(port, case.name) == 0))
    assert dirichlet.any() and not W[dirichlet].any()
    assert np.abs(W[~dirichlet].sum(axis=1) - 1.0).max() < 1e-12
    Wsub, _ = port.prepare_interpolator(method, case.name, tp[1::3])
    assert np.abs(Wsub - W[1::3]).max() < 1e-15


def test_many_chunk_plan_matches_one_chunk(setups):
    """Classes split into many chunks scatter into the same rows."""
    case, _, port = setups("mixed", 3)
    tp = np.arange(port.grid.n_points)
    for method in ("idw", "ls"):
        W, _ = port.prepare_interpolator(method, case.name, tp)
        impl = getattr(port, method)
        impl.chunk_nodes = 7
        try:
            W2, _ = port.prepare_interpolator(method, case.name, tp)
        finally:
            impl.chunk_nodes = 131072
        assert np.abs(W - W2).max() < 1e-15
