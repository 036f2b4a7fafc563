"""The unfused CholeskyQR2 route of the PyTorch port (ops/cholqr.py and
_methods/gls.py::gls_solve_unfused) vs ninpol_tpu: each plain version
against its Pallas kernel in interpret mode, the clamped-pivot flag, the
whole ``shard_geometry=True`` route against
``ninpol_tpu.Interpolator(mesh=1, shard_geometry=True)`` and the dgels
oracle, the default device, and, on a card, each CUDA kernel against its
plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninpol_tpu
import ninpol_tpu_torch
from ninpol_tpu.ops import pallas_chol
from ninpol_tpu.utils import meshgen
from ninpol_tpu_torch._methods.gls import gls_gather, gls_solve_unfused
from ninpol_tpu_torch.interop import from_state
from ninpol_tpu_torch.ops import cholqr
from ninpol_tpu_torch.ops import gls_solve as gs
from tests.utils.cases import ALHCase
from tests.utils.oracle import gls_oracle

TOL = 1e-10          # scaled by max |w|: the reference's parity bar
RNORM_TOL = 1e-11    # the exact-fallback threshold
# float32 kernels, scaled by the per-node max of the reference output:
# ~100 eps32 of room for another summation order; L^-1 P compounds the
# rounding of two factors
F32_TOL = 1e-5
F32_TOL_MUL = 1e-4
SHAPES = [(40, 13), (108, 37)]
KERNELS = ["gram", "round2", "chol_linv", "chol_linv_mul", "prec_apply"]
PLAIN = ["gram_f32_reference", "chol_linv_f32_reference",
         "round2_gram_f32_reference", "prec_apply_f32_reference"]
# plain-version calls per solve chunk of the unfused route
PER_CHUNK = dict(zip(PLAIN, (1, 2, 1, 4)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's default of one
    thread per core would oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled_err(x, ref):
    """max over nodes of max|x - ref| / max|ref|, per node."""
    x, ref = (np.asarray(a, np.float64).reshape(len(a), -1) for a in (x, ref))
    return float((np.abs(x - ref).max(1) / np.abs(ref).max(1)).max())


def _kernel_inputs(kernel, m, n, B=128, seed=0):
    """Seeded float32 inputs of one kernel, shaped as the unfused route
    makes them: equilibrated A, the shifted Gram G1 and its inverse
    factor Li1, the round-2 Gram G2, and a vector."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, n))
    A /= np.linalg.norm(A, axis=1, keepdims=True)
    G1 = np.einsum("bmi,bmj->bij", A, A) + 1.5e-5 * np.eye(n)
    Li1 = np.linalg.inv(np.linalg.cholesky(G1))
    Q = np.einsum("bmj,bkj->bmk", A, Li1)
    G2 = np.einsum("bmi,bmj->bij", Q, Q)
    v = rng.standard_normal((B, n))
    f32 = lambda *xs: tuple(np.ascontiguousarray(x, np.float32) for x in xs)
    return {"gram": f32(A), "round2": f32(A, Li1), "chol_linv": f32(G1),
            "chol_linv_mul": f32(G2, Li1),
            "prec_apply": f32(np.tril(Li1 @ Li1), v)}[kernel]


def _port(kernel, *xs):
    """The port's wrapper of ``kernel`` on the tensors xs."""
    if kernel == "chol_linv_mul":
        return cholqr.chol_linv_f32(xs[0], mul_right=xs[1])
    return {"gram": cholqr.gram_f32, "round2": cholqr.round2_gram_f32,
            "chol_linv": cholqr.chol_linv_f32,
            "prec_apply": cholqr.prec_apply_f32}[kernel](*xs)


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_matches_pallas_kernel(monkeypatch, kernel, m, n):
    """Each plain version against ninpol_tpu's Pallas kernel, run in
    interpret mode (the TPU branch of pallas_chol, forced on the CPU for
    the kernel call only), on the same float32 inputs."""
    xs = _kernel_inputs(kernel, m, n)
    fn = {"gram": pallas_chol.gram_f32,
          "round2": pallas_chol.round2_gram_f32,
          "chol_linv": pallas_chol.chol_linv_f32,
          "chol_linv_mul": lambda G, P: pallas_chol.chol_linv_f32(
              G, mul_right=P),
          "prec_apply": pallas_chol.prec_apply_f32}[kernel]
    args = [jnp.asarray(x) for x in xs]
    with monkeypatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        mp.setattr(pallas_chol, "INTERPRET", True)
        ref = np.asarray(fn(*args))
    got = _port(kernel, *(torch.from_numpy(x) for x in xs)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    tol = F32_TOL_MUL if kernel == "chol_linv_mul" else F32_TOL
    assert _scaled_err(got, ref) < tol


def test_clamped_pivot_flags_both_rounds():
    """A clamped round-1 pivot shows in |diag(Li1)| ~ 1/sqrt(tiny); a large
    round-2 pivot can pull |diag(Lc)| back under the threshold, so the
    unfused route's flag reads both rounds (ninpol_tpu's
    test_pallas.py:266-290, through the port's chol_linv_f32)."""
    B, n = 4, 8
    G1 = torch.eye(n).repeat(B, 1, 1)
    G1[:, n - 1, n - 1] = 1e-14             # below tiny = 1e-12: clamped
    Li1 = cholqr.chol_linv_f32(G1)
    d_r1 = Li1.diagonal(dim1=1, dim2=2).abs().max().item()
    assert d_r1 > cholqr.SICK_DINV
    G2 = torch.eye(n).repeat(B, 1, 1)
    G2[:, n - 1, n - 1] = 1e8               # round 2 "compensates"
    Lc = cholqr.chol_linv_f32(G2, mul_right=Li1)
    d_comb = Lc.diagonal(dim1=1, dim2=2).abs().max().item()
    assert d_comb < cholqr.SICK_DINV
    assert max(d_comb, d_r1) > cholqr.SICK_DINV


def _port_chunk(neumann=False):
    """Solve inputs of one class chunk of the port's own plan (tetra
    mesh of size 3), gathered with the unfused route's tau guard."""
    case = ALHCase()
    case.assign_mesh_properties(meshgen.tetra_mesh(3), seed=0)
    port = ninpol_tpu_torch.Interpolator(device="cpu")
    port.load_mesh(mesh_obj=case.mesh)
    classes, ft, nflag = port.gls.plan(
        port.device_grid, port.cells_data, port.points_data,
        port.variable_to_index, case.name, np.arange(port.grid.n_points))
    c = [c for c in classes if c["with_neumann"] == neumann][0]
    inp, _ = gls_gather(port.device_grid, ft, nflag,
                        torch.as_tensor(c["nodes"]), c["E"], c["F"], neumann,
                        tau_guard="norm")
    return inp


def test_unfused_solve_forces_rnorm_one_on_clamped_pivot():
    """A rank-deficient node (every cell's x- and y-gradient columns made
    identical) clamps a pivot: the both-rounds flag sets rnorm to exactly
    1, the exact-fallback signal.  Untouched nodes converge."""
    inp = _port_chunk()
    sick = inp["dk"].shape[0] // 2
    for key in ("dk", "l1", "l2", "t1m", "tt"):
        inp[key] = inp[key].clone()
        inp[key][sick, :, 1] = inp[key][sick, :, 0]
    w, wn, rnorm = gls_solve_unfused(**inp)
    assert rnorm[sick].item() == 1.0
    others = torch.arange(len(rnorm)) != sick
    assert (rnorm[others] < RNORM_TOL).all()
    assert torch.isfinite(w[others]).all() and torch.isfinite(wn[others]).all()


def test_unfused_solve_matches_fused_plain_version():
    """The two routes solve the same systems: gls_solve_unfused against
    gls_solve_reference on one Neumann chunk, at the reference's bar."""
    inp = _port_chunk(neumann=True)
    assert inp["lb"] is not None
    w, wn, rn = gls_solve_unfused(**inp)
    wr, wnr, rnr = gs.gls_solve_reference(**inp)
    conv = (rn <= RNORM_TOL) & (rnr <= RNORM_TOL)
    assert conv.sum() >= 8
    scale = max(wr.abs().max().item(), 1.0)
    assert (w - wr)[conv].abs().max().item() / scale < TOL
    assert (wn - wnr)[conv].abs().max().item() / scale < TOL


def test_wrappers_reject_bad_inputs():
    """Each wrapper checks dimensions, dtype, shape and contiguity before
    any launch."""
    A = torch.zeros(4, 10, 5)
    with pytest.raises(ValueError, match="A must have 3 dimensions"):
        cholqr.gram_f32(A[0])
    with pytest.raises(ValueError, match="A must be torch.float32"):
        cholqr.gram_f32(A.double())
    with pytest.raises(ValueError, match="G must be"):
        cholqr.chol_linv_f32(torch.zeros(4, 5, 6))
    with pytest.raises(ValueError, match="mul_right must be"):
        cholqr.chol_linv_f32(torch.eye(5).repeat(4, 1, 1),
                             mul_right=torch.zeros(4, 5, 4))
    with pytest.raises(ValueError, match="Li must be contiguous"):
        cholqr.round2_gram_f32(A, torch.zeros(4, 5, 5).transpose(1, 2))
    with pytest.raises(ValueError, match="v must be"):
        cholqr.prec_apply_f32(torch.zeros(4, 5, 5), torch.zeros(4, 6))


def test_cpu_wrappers_run_plain_versions_without_counting():
    """On CPU tensors each wrapper IS its plain version and counts no
    kernel launch."""
    wrappers = (cholqr.gram_f32, cholqr.chol_linv_f32,
                cholqr.round2_gram_f32, cholqr.prec_apply_f32)
    before = [w.launches for w in wrappers]
    A, Li = (torch.from_numpy(x) for x in _kernel_inputs("round2", 40, 13))
    G = cholqr.gram_f32(A)
    torch.testing.assert_close(G, cholqr.gram_f32_reference(A), rtol=0,
                               atol=0)
    torch.testing.assert_close(cholqr.chol_linv_f32(G),
                               cholqr.chol_linv_f32_reference(G), rtol=0,
                               atol=0)
    torch.testing.assert_close(cholqr.round2_gram_f32(A, Li),
                               cholqr.round2_gram_f32_reference(A, Li),
                               rtol=0, atol=0)
    v = A[:, 0, :].contiguous()
    torch.testing.assert_close(cholqr.prec_apply_f32(Li, v),
                               cholqr.prec_apply_f32_reference(Li, v),
                               rtol=0, atol=0)
    assert [w.launches for w in wrappers] == before


class Setups:
    """Per mesh: the case, ninpol_tpu's mesh=1 shard_geometry=True
    interpolator with its prepared weights and CSR, and the port's
    counterpart on the CPU (mesh=1, shard_geometry=True: the unfused
    route on one partitioned shard); built on first use."""

    def __init__(self):
        self._made = {}

    def __call__(self, fam, n):
        if (fam, n) not in self._made:
            case = ALHCase()
            case.assign_mesh_properties(meshgen.FAMILIES[fam](n), seed=0)
            ref = ninpol_tpu.Interpolator(mesh=1, shard_geometry=True)
            ref.load_mesh(mesh_obj=case.mesh)
            tp = np.arange(ref.grid.n_points)
            ref_w = ref.prepare_interpolator("gls", case.name, tp)
            ref_csr = ref.interpolate(case.name, "gls")
            port = ninpol_tpu_torch.Interpolator(device="cpu", mesh=1,
                                                 shard_geometry=True)
            port.load_mesh(mesh_obj=case.mesh)
            self._made[(fam, n)] = (case, ref, ref_w, ref_csr, port)
        return self._made[(fam, n)]


@pytest.fixture(scope="module")
def setups():
    return Setups()


MESHES = [("hexa", 3), ("tetra", 2), ("mixed", 2)]


def _oracle(interp, var, tp):
    v2i = interp.variable_to_index
    return gls_oracle(
        interp.grid, tp, interp.cells_data[v2i["cells"]["permeability"]],
        interp.cells_data[v2i["cells"]["diff_mag"]],
        interp.points_data[v2i["points"][f"neumann_flag_{var}"]].astype(
            np.int64),
        interp.points_data[v2i["points"][f"neumann_{var}"]],
        return_cond=True)


@pytest.mark.parametrize("fam,n", MESHES)
def test_unfused_route_matches_reference_and_oracle(setups, fam, n):
    """shard_geometry=True weights and Neumann vector against ninpol_tpu's
    unfused route and against dgels (cond < 1e7), at 1e-10 scaled."""
    case, _, (Wr, NWr), _, port = setups(fam, n)
    tp = np.arange(port.grid.n_points)
    W, NW = port.prepare_interpolator("gls", case.name, tp)
    scale = max(np.abs(Wr).max(), 1.0)
    assert np.abs(W - Wr).max() / scale < TOL
    assert np.abs(NW - NWr).max() / scale < TOL
    Wo, NWo, cond = _oracle(port, case.name, tp)
    ok = cond < 1e7
    assert ok.sum() > len(tp) // 2
    scale = max(np.abs(Wo[ok]).max(), 1.0)
    assert np.abs(W[ok] - Wo[ok]).max() / scale < TOL
    assert np.abs(NW[ok] - NWo[ok]).max() / scale < TOL


@pytest.mark.parametrize("fam,n", MESHES)
def test_unfused_route_csr_matches_reference(setups, fam, n):
    case, _, _, (Mr, neur), port = setups(fam, n)
    M, neu = port.interpolate(case.name, "gls")
    assert M.shape == Mr.shape == (port.grid.n_points, port.grid.n_elems)
    np.testing.assert_array_equal(M.indptr, Mr.indptr)
    np.testing.assert_array_equal(M.indices, Mr.indices)
    assert np.abs(M.data - Mr.data).max() < TOL
    assert np.abs(neu - neur).max() < TOL


@pytest.mark.parametrize("fam,n", MESHES)
def test_unfused_route_calls_each_piece_per_chunk(setups, monkeypatch,
                                                  fam, n):
    """One prepare of the unfused route calls, per solve chunk, 1 gram,
    2 chol_linv, 1 round2_gram and 4 prec_apply (plain versions on the
    CPU), and never the fused solve."""
    case, _, _, _, port = setups(fam, n)
    calls = dict.fromkeys(PLAIN + ["gls_solve_reference"], 0)

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    for name in PLAIN:
        counting(cholqr, name)
    counting(gs, "gls_solve_reference")
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
                     "gls_solve_reference": 0}


def test_route_is_part_of_the_prepared_weights_cache_key(setups,
                                                         monkeypatch):
    """interpolate() caches prepared weights; switching the route must
    not serve the other route's cached result."""
    case, ref, _, _, _ = setups("hexa", 3)
    port = from_state(ref._make_cache(ref.process_mesh(ref.mesh_obj)),
                      device="cpu")
    port.gls.fused = False               # the unfused route on one device
    port.interpolate(case.name, "gls")
    calls = []
    for mod, name in ((cholqr, "gram_f32_reference"),
                      (gs, "gls_solve_reference")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=fn, **k:
                            calls.append(_n) or _f(*a, **k))
    port.interpolate(case.name, "gls")
    assert calls == []                   # served from the cache
    port.gls.fused = True
    port.interpolate(case.name, "gls")
    assert set(calls) == {"gls_solve_reference"}   # the fused route ran
    calls.clear()
    port.gls.fused = False
    port.interpolate(case.name, "gls")
    assert calls == []                   # both routes cached, none redone


def test_default_device_is_cuda_without_cpu_fallback(monkeypatch):
    """With no device argument the port runs on the CUDA card; with no
    card it raises at the first device use instead of running on the
    CPU.  device='cpu' stays the explicit CPU route."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = meshgen.tetra_mesh(2)
    port = ninpol_tpu_torch.Interpolator()
    port.load_mesh(mesh_obj=mesh)        # the host grid needs no device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.device_grid
    cpu = ninpol_tpu_torch.Interpolator(device="cpu")
    cpu.load_mesh(mesh_obj=mesh)
    assert cpu.device_grid.device == torch.device("cpu")


def _backward_error(X, G, P=None):
    """max over nodes of max|X W X^T - I| in float64, W = P^-1 G P^-T (G
    itself without P): how far X = L^-1 P is from a true inverse factor of
    G = L L^T."""
    X, G = X.double(), G.double()
    if P is not None:
        Pi = torch.linalg.inv(P.double())
        G = Pi @ G @ Pi.transpose(1, 2)
    eye = torch.eye(G.shape[1], dtype=G.dtype, device=G.device)
    return (X @ G @ X.transpose(1, 2) - eye).abs().amax().item()


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", KERNELS)
def test_cuda_kernel_matches_plain_version(kernel):
    """Each CUDA kernel against its plain version on the card, on the
    same inputs: the products within F32_TOL scaled per node, the inverse
    factors by backward error within 10x the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    xs = [torch.from_numpy(x).cuda() for x in _kernel_inputs(kernel, 108, 37)]
    wrapper = {"gram": cholqr.gram_f32, "round2": cholqr.round2_gram_f32,
               "prec_apply": cholqr.prec_apply_f32}.get(
                   kernel, cholqr.chol_linv_f32)
    plain = getattr(cholqr, {"gram": "gram_f32_reference",
                             "round2": "round2_gram_f32_reference",
                             "prec_apply": "prec_apply_f32_reference"}.get(
                                 kernel, "chol_linv_f32_reference"))
    before = wrapper.launches
    got = _port(kernel, *xs)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    if kernel.startswith("chol_linv"):
        P = xs[1] if kernel == "chol_linv_mul" else None
        ref = plain(xs[0], mul_right=P)
        assert (_backward_error(got, xs[0], P)
                <= 10 * _backward_error(ref, xs[0], P))
    else:
        assert _scaled_err(got.cpu(), plain(*xs).cpu()) < F32_TOL
