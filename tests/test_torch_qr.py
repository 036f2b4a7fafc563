"""The CSNE cross-check route of the PyTorch port (ops/qr.py and
_methods/gls.py::gls_solve_csne, ``gls.solver = "pallas"``) vs
ninpol_tpu: each plain version against its Pallas kernel in interpret
mode, the whole route against ``ninpol_tpu.Interpolator`` with the same
solver and against the dgels oracle, the solver setting, and, on a card,
each CUDA kernel against its plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninpol_tpu
import ninpol_tpu_torch
from ninpol_tpu.ops import pallas_qr
from ninpol_tpu.utils import meshgen
from ninpol_tpu_torch.ops import cholqr
from ninpol_tpu_torch.ops import gls_solve as gs
from ninpol_tpu_torch.ops import qr
from tests.utils.cases import ALHCase
from tests.utils.oracle import gls_oracle

TOL = 1e-10          # scaled by max |w|: the reference's parity bar
# R of the df32 kernel (~2^-44 a step) against float64, scaled per node
QR_TOL = 1e-12
# y of the df32 solve against float64, scaled per node: the forward error
# is ~cond(R)^2 u, and these random A have cond < 10
SNE_TOL = 1e-11
# (B, m, n, rows of A that are not zero): test_pallas.py's shape, and one
# like the route's Neumann class (m = 145 with the appended rows, padded
# to the TPU kernel's multiple of 32)
SHAPES = [(128, 64, 25, 50), (128, 160, 37, 145)]
PLAIN = ["qr_r_reference", "sne_solve_reference"]
PER_CHUNK = dict(zip(PLAIN, (1, 2)))     # plain calls per solve chunk
MESHES = [("tetra", 2), ("hexa", 3), ("mixed", 2)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's default of one
    thread per core would oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def interpret_mode():
    """ninpol_tpu's qr kernels in interpret mode, as test_pallas.py runs
    them on the CPU."""
    old = pallas_qr.INTERPRET
    pallas_qr.INTERPRET = True
    yield
    pallas_qr.INTERPRET = old


def _scaled_err(x, ref):
    """max over nodes of max|x - ref| / max|ref|, per node."""
    x, ref = (np.asarray(a, np.float64).reshape(len(a), -1) for a in (x, ref))
    return float((np.abs(x - ref).max(1) / np.abs(ref).max(1)).max())


class PallasQR:
    """Per shape: the seeded A as ninpol_tpu's float32 pair, and its
    R pair from qr_r_df32; computed on first use."""

    def __init__(self):
        self._made = {}

    def __call__(self, shape):
        if shape not in self._made:
            B, m, n, rows = shape
            rng = np.random.default_rng(rows)
            A = np.zeros((B, m, n))
            A[:, :rows] = rng.standard_normal((B, rows, n))
            Ah = A.astype(np.float32)
            Al = (A - Ah).astype(np.float32)
            Rh, Rl = pallas_qr.qr_r_df32(jnp.asarray(Ah), jnp.asarray(Al))
            self._made[shape] = (Ah, Al, Rh, Rl)
        return self._made[shape]


@pytest.fixture(scope="module")
def pallas_r():
    return PallasQR()


def _f64(h, lo):
    """A float32 pair as the float64 it stands for: exact."""
    return np.asarray(h).astype(np.float64) + np.asarray(lo)


def _port_r(Rh, Rl):
    """The (m, n, B) pair's leading n rows as (B, n, n) upper-triangular
    float64 (below the diagonal the TPU kernel leaves rounding residue)."""
    n = Rh.shape[1]
    return np.ascontiguousarray(
        np.triu(np.transpose(_f64(Rh, Rl)[:n], (2, 0, 1))))


def _rhs(kind, B, n):
    if kind == "e_n":
        b = np.zeros((B, n))
        b[:, -1] = 1.0
        return b
    # float32 values, so the TPU kernel's pair (b, 0) is this b exactly
    return np.random.default_rng(n).standard_normal((B, n)).astype(
        np.float32).astype(np.float64)


def _pallas_sne(Rh, Rl, b):
    bh = b.astype(np.float32)
    yh, yl = pallas_qr.sne_solve_df32(Rh, Rl, jnp.asarray(bh),
                                      jnp.asarray((b - bh).astype(np.float32)))
    return _f64(yh, yl)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_qr_matches_pallas_kernel(pallas_r, shape):
    """qr_r_reference on A = Ah + Al against qr_r_df32 on the pair: the
    same R entry by entry (the same sign convention), zeros below the
    diagonal."""
    Ah, Al, Rh, Rl = pallas_r(shape)
    R = qr.qr_r_reference(torch.from_numpy(_f64(Ah, Al))).numpy()
    n = shape[2]
    assert R.shape == (shape[0], n, n) and R.dtype == np.float64
    assert not np.tril(R, -1).any()
    assert _scaled_err(R, _port_r(Rh, Rl)) < QR_TOL


@pytest.mark.parametrize("kind", ["e_n", "random"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_sne_matches_pallas_kernel(pallas_r, shape, kind):
    """sne_solve_reference against sne_solve_df32 on the same R."""
    _, _, Rh, Rl = pallas_r(shape)
    b = _rhs(kind, shape[0], shape[2])
    y = qr.sne_solve_reference(torch.from_numpy(_port_r(Rh, Rl)),
                               torch.from_numpy(b)).numpy()
    assert _scaled_err(y, _pallas_sne(Rh, Rl, b)) < SNE_TOL


def test_clamped_pivot_counts_as_one(pallas_r):
    """A diagonal entry under tiny = 1e-7 is taken as exactly 1 by both
    solves."""
    _, _, Rh, Rl = pallas_r(SHAPES[0])
    node, k = 3, 5
    Rh = Rh.at[k, k, node].set(1e-9)
    Rl = Rl.at[k, k, node].set(0.0)
    R = _port_r(Rh, Rl)
    b = _rhs("random", *R.shape[:2])
    y = qr.sne_solve_reference(torch.from_numpy(R), torch.from_numpy(b))
    assert _scaled_err(y.numpy(), _pallas_sne(Rh, Rl, b)) < SNE_TOL
    R1 = R.copy()
    R1[node, k, k] = 1.0
    y1 = qr.sne_solve_reference(torch.from_numpy(R1), torch.from_numpy(b))
    torch.testing.assert_close(y, y1, rtol=0, atol=0)


def test_r_diag_quality_matches_pallas_qr(pallas_r):
    """min|diag| / max|diag| of R, as pallas_qr.r_diag_quality reads it
    from the float32 high part."""
    _, _, Rh, Rl = pallas_r(SHAPES[1])
    R = _port_r(Rh, np.zeros_like(Rl))
    got = qr.r_diag_quality(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas_qr.r_diag_quality(Rh)),
                               rtol=1e-6, atol=0)


class Setups:
    """Per mesh: the case and the port's CPU interpolator with
    ``gls.solver = "pallas"``; built on first use."""

    def __init__(self):
        self._made = {}

    def __call__(self, fam, n):
        if (fam, n) not in self._made:
            case = ALHCase()
            case.assign_mesh_properties(meshgen.FAMILIES[fam](n), seed=0)
            port = ninpol_tpu_torch.Interpolator(device="cpu")
            port.load_mesh(mesh_obj=case.mesh)
            port.gls.solver = "pallas"
            self._made[(fam, n)] = (case, port)
        return self._made[(fam, n)]


@pytest.fixture(scope="module")
def setups():
    return Setups()


@pytest.fixture(scope="module")
def reference(setups):
    """ninpol_tpu's interpolate() with solver="pallas" on ALH
    tetra_mesh(2), its qr kernels in interpret mode: one run, whose
    prepared weights interpolate() keeps in its cache."""
    case, _ = setups("tetra", 2)
    ref = ninpol_tpu.Interpolator()
    ref.load_mesh(mesh_obj=case.mesh)
    ref.gls.solver = "pallas"
    csr = ref.interpolate(case.name, "gls")
    (weights,) = ref._prep_cache.values()
    return csr, weights


def test_csne_route_matches_reference(setups, reference):
    """The port's solver="pallas" route against ninpol_tpu's: weights,
    Neumann vector and CSR data within 1e-10 scaled, the same CSR pattern.
    Which nodes fall back is not compared: the TPU route's df32 rnorm is
    larger than the port's float64 one, so it sends nodes to the exact
    path that the port does not (the weights agree either way)."""
    case, port = setups("tetra", 2)
    (Mr, neur), (Wr, NWr) = reference
    W, NW = port.prepare_interpolator("gls", case.name,
                                      np.arange(port.grid.n_points))
    scale = max(np.abs(Wr).max(), 1.0)
    assert np.abs(W - Wr).max() / scale < TOL
    assert np.abs(NW - NWr).max() / scale < TOL
    M, neu = port.interpolate(case.name, "gls")
    assert M.shape == Mr.shape == (port.grid.n_points, port.grid.n_elems)
    np.testing.assert_array_equal(M.indptr, Mr.indptr)
    np.testing.assert_array_equal(M.indices, Mr.indices)
    scale = max(np.abs(Mr.data).max(), 1.0)
    assert np.abs(M.data - Mr.data).max() / scale < TOL
    assert np.abs(neu - neur).max() / max(np.abs(neur).max(), 1.0) < TOL


@pytest.mark.parametrize("fam,n", MESHES)
def test_csne_route_matches_oracle(setups, fam, n):
    """Weights and Neumann vector against dgels (cond < 1e7) at 1e-10
    scaled, with no node sent to the exact fallback."""
    case, port = setups(fam, n)
    tp = np.arange(port.grid.n_points)
    W, NW = port.prepare_interpolator("gls", case.name, tp)
    assert port.gls.last_n_bad == 0
    v2i = port.variable_to_index
    Wo, NWo, cond = gls_oracle(
        port.grid, tp, port.cells_data[v2i["cells"]["permeability"]],
        port.cells_data[v2i["cells"]["diff_mag"]],
        port.points_data[v2i["points"][f"neumann_flag_{case.name}"]].astype(
            np.int64),
        port.points_data[v2i["points"][f"neumann_{case.name}"]],
        return_cond=True)
    ok = cond < 1e7
    assert ok.sum() > len(tp) // 2
    scale = max(np.abs(Wo[ok]).max(), 1.0)
    assert np.abs(W[ok] - Wo[ok]).max() / scale < TOL
    assert np.abs(NW[ok] - NWo[ok]).max() / scale < TOL


@pytest.mark.parametrize("fam,n", MESHES[1:])
def test_csne_route_calls_each_piece_per_chunk(setups, monkeypatch, fam, n):
    """One prepare of the route calls, per solve chunk, 1 qr_r and 2
    sne_solve (plain versions on the CPU), and no plain version of the
    CholeskyQR2 routes."""
    case, port = setups(fam, n)
    others = ["gls_solve_reference"] + [f"{k}_reference" for k in (
        "gram_f32", "chol_linv_f32", "round2_gram_f32", "prec_apply_f32")]
    calls = dict.fromkeys(PLAIN + others, 0)

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    for name in calls:
        counting(qr if name in PLAIN else gs if name == others[0] else cholqr,
                 name)
    tp = np.arange(port.grid.n_points)
    port.gls.chunk_nodes = 4           # several chunks per class
    try:
        port.prepare_interpolator("gls", case.name, tp)
        classes, _, _ = port.gls.plan(
            port.device_grid, port.cells_data, port.points_data,
            port.variable_to_index, case.name, tp)
    finally:
        port.gls.chunk_nodes = 32768
    chunks = sum(-(-len(c["nodes"]) // c["chunk"]) for c in classes)
    assert chunks > len(classes)
    assert calls == {**{k: v * chunks for k, v in PER_CHUNK.items()},
                     **dict.fromkeys(others, 0)}


def test_solver_is_part_of_the_prepared_weights_cache_key(setups,
                                                          monkeypatch):
    """interpolate() caches prepared weights; switching the solver must
    not serve the other solver's cached result."""
    case, _ = setups("hexa", 3)
    port = ninpol_tpu_torch.Interpolator(device="cpu")
    port.load_mesh(mesh_obj=case.mesh)
    M_auto, _ = port.interpolate(case.name, "gls")
    calls = []
    for mod, name in ((qr, "qr_r_reference"), (gs, "gls_solve_reference")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=fn, **k:
                            calls.append(_n) or _f(*a, **k))
    port.gls.solver = "pallas"
    M_csne, _ = port.interpolate(case.name, "gls")
    assert set(calls) == {"qr_r_reference"}        # the CSNE route ran
    assert np.abs(M_csne.data - M_auto.data).max() < TOL
    calls.clear()
    port.gls.solver = "auto"
    port.interpolate(case.name, "gls")
    port.gls.solver = "pallas"
    port.interpolate(case.name, "gls")
    assert calls == []                   # both cached, none redone


def test_qr_wrappers_reject_bad_inputs():
    """Each wrapper checks dimensions, dtype, shape, row count and
    contiguity before any launch."""
    A = torch.zeros(4, 10, 5, dtype=torch.float64)
    with pytest.raises(ValueError, match="A must have 3 dimensions"):
        qr.qr_r(A[0])
    with pytest.raises(ValueError, match="A must be torch.float64"):
        qr.qr_r(A.float())
    with pytest.raises(ValueError, match="at least as many rows"):
        qr.qr_r(A.transpose(1, 2).contiguous())
    with pytest.raises(ValueError, match="A must be contiguous"):
        qr.qr_r(A.transpose(1, 2).transpose(1, 2)[:, ::2])
    R = torch.eye(5, dtype=torch.float64).repeat(4, 1, 1)
    with pytest.raises(ValueError, match="R must be"):
        qr.sne_solve(R[:, :, :4], torch.zeros(4, 5, dtype=torch.float64))
    with pytest.raises(ValueError, match="b must be"):
        qr.sne_solve(R, torch.zeros(4, 6, dtype=torch.float64))


def test_cpu_qr_wrappers_run_plain_versions_without_counting(pallas_r):
    """On CPU tensors each wrapper IS its plain version and counts no
    kernel launch."""
    before = [w.launches for w in qr.KERNELS]
    Ah, Al, _, _ = pallas_r(SHAPES[0])
    A = torch.from_numpy(_f64(Ah, Al))
    R = qr.qr_r(A)
    torch.testing.assert_close(R, qr.qr_r_reference(A), rtol=0, atol=0)
    b = torch.from_numpy(_rhs("random", *R.shape[:2]))
    torch.testing.assert_close(qr.sne_solve(R, b),
                               qr.sne_solve_reference(R, b), rtol=0, atol=0)
    assert [w.launches for w in qr.KERNELS] == before


def test_error_measures_tell_a_right_result_from_a_wrong_one(pallas_r):
    """The measures by which the card's kernels are held to their plain
    versions: roundoff-sized on the plain results, large where one entry
    of R or y is off by 1e-4 of it."""
    Ah, Al, _, _ = pallas_r(SHAPES[1])
    A = torch.from_numpy(_f64(Ah, Al))
    R = qr.qr_r_reference(A)
    b = torch.from_numpy(_rhs("random", *R.shape[:2]))
    y = qr.sne_solve_reference(R, b)
    assert qr.gram_backward_error(R, A) < 1e-14
    assert qr.sne_residual(R, y, b) < 1e-15
    Rw, yw = R.clone(), y.clone()
    Rw[7, 2, 9] *= 1 + 1e-4
    yw[7, 4] *= 1 + 1e-4
    assert qr.gram_backward_error(Rw, A) > 1e-9
    assert qr.sne_residual(R, yw, b) > 1e-9


def _card_inputs(B, m, n, seed=0):
    """A seeded (B, m, n) float64 A on the card, with an identity row
    appended for a zero column as the route does."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m - n, n))
    A[:, :, n // 2] = 0.0
    reg = np.zeros((B, n, n))
    reg[:, n // 2, n // 2] = 1.0
    return torch.from_numpy(np.concatenate([A, reg], axis=1)).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(145, 37), (205, 73)])
def test_cuda_qr_kernels_match_plain_versions(m, n):
    """qr_r and sne_solve on the card against their plain versions on the
    same inputs: R by backward error, y by residual, each within 10x the
    plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    A = _card_inputs(256, m, n)
    before = [w.launches for w in qr.KERNELS]
    R = qr.qr_r(A)
    Rp = qr.qr_r_reference(A)
    torch.cuda.synchronize()
    assert not torch.tril(R, -1).any()
    assert qr.gram_backward_error(R, A) <= 10 * qr.gram_backward_error(Rp, A)
    b = torch.randn((A.shape[0], n), dtype=torch.float64, device=A.device,
                    generator=torch.Generator(device=A.device).manual_seed(0))
    y = qr.sne_solve(Rp, b)
    yp = qr.sne_solve_reference(Rp, b)
    torch.cuda.synchronize()
    assert qr.sne_residual(Rp, y, b) <= 10 * qr.sne_residual(Rp, yp, b)
    assert [w.launches for w in qr.KERNELS] == [x + 1 for x in before]
