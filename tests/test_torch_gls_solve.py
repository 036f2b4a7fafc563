"""The GLS solve of the PyTorch port (ops/gls_solve.py) vs ninpol_tpu's:
the plain PyTorch version against the Pallas kernel (interpret mode) and
against the JAX CPU composition of the same algorithm; the clamped-pivot
flag; and, on a card, the CUDA kernel against its plain version."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ninpol_tpu
import ninpol_tpu_torch
from ninpol_tpu._methods import gls as ref_gls
from ninpol_tpu.ops import pallas_chol
from ninpol_tpu.utils import meshgen
from ninpol_tpu_torch._methods.gls import gls_epilogue, gls_gather
from ninpol_tpu_torch.interop import from_state, tiles_from_reference
from ninpol_tpu_torch.ops.gls_solve import gls_solve, gls_solve_reference
from tests.utils.cases import ALHCase
from tests.utils.oracle import gls_oracle

TOL = 1e-10          # scaled by max |w|: the reference's parity bar
RNORM_TOL = 1e-11    # the exact-fallback threshold


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's default of one
    thread per core would oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(fam, n):
    case = ALHCase()
    case.assign_mesh_properties(meshgen.FAMILIES[fam](n), seed=0)
    ref = ninpol_tpu.Interpolator()
    ref.load_mesh(mesh_obj=case.mesh)
    return case, ref


def _fields(interp, var):
    v2i = interp.variable_to_index
    return (interp.cells_data[v2i["cells"]["permeability"]].reshape(-1, 3, 3),
            interp.cells_data[v2i["cells"]["diff_mag"]],
            interp.points_data[v2i["points"][f"neumann_flag_{var}"]],
            interp.points_data[v2i["points"][f"neumann_{var}"]])


def _ref_bucket(ref, var, neumann):
    """The first bucket of ninpol_tpu's plan for the interior or the
    Neumann nodes, with the arguments of its gather/solve functions."""
    perm, dmag, nflag, nval = _fields(ref, var)
    g, dg = ref.grid, ref.device_grid
    face_pack = ref_gls.build_face_pack(dg, perm, dmag, nval)
    tp = np.arange(g.n_points)
    active = ~(g.boundary_points.astype(bool) & (nflag == 0))
    mask = active & ((nflag != 0) if neumann else (nflag == 0))
    bucket = dg.buckets(tp, mask)[0]
    args = (jnp.asarray(bucket["nodes"]), jnp.asarray(bucket["valid"]),
            dg.esup2d, dg.esup_cnt, dg.fsup2d, dg.fsup_cnt,
            dg.point_pack, dg.cell_pack, face_pack,
            jnp.asarray(nflag.astype(np.int32)))
    return bucket, args


def _torch(inp):
    return {k: None if v is None else torch.as_tensor(np.ascontiguousarray(v))
            for k, v in inp.items()}


def _untile(x):
    x = np.asarray(x)
    return np.transpose(x, (0, 2, 1)).reshape(-1, x.shape[1])


@pytest.fixture(scope="module")
def neumann_tile():
    """One 128-node Neumann tile of an ALH tetra_mesh(2): ninpol_tpu's
    gathered tiles, the port's float64 solve inputs rebuilt from them,
    the reference interpolator and its bucket."""
    case, ref = _reference("tetra", 2)
    bucket, args = _ref_bucket(ref, case.name, neumann=True)
    tiles = ref_gls._gls_gather_fused(*args, E=bucket["E"], F=bucket["F"],
                                      wneu=True)
    inp = tiles_from_reference(tiles)
    inp = _torch({k: None if v is None else v[:128] for k, v in inp.items()})
    return case, ref, bucket, tiles, inp


def _hold_to_interpret_kernel(neumann_tile, rounds, sweeps):
    """gls_solve_fused(rounds=) in interpret mode on the tile's df32
    planes vs the plain version (cholqr2_solve on cholqr.PLAIN) on the
    same planes rebuilt as float64, at the reference's 1e-10 bar, on the
    nodes the interpret kernel calls converged; the others to dgels."""
    case, ref, bucket, tiles, inp = neumann_tile
    tile = [t[:1] for t in tiles[:8]]                 # one 128-node tile
    old = pallas_chol.INTERPRET
    pallas_chol.INTERPRET = True
    try:
        wh, wl, wnh, wnl, rn = pallas_chol.gls_solve_fused(
            *tile, True, sweeps=sweeps, rounds=rounds)
    finally:
        pallas_chol.INTERPRET = old
    w_ref = _untile(wh).astype(np.float64) + _untile(wl)
    wn_ref = (_untile(wnh).astype(np.float64) + _untile(wnl))[:, 0]
    rn_ref = _untile(rn)[:, 0].astype(np.float64)

    assert inp["lb"] is not None and inp["valid"].any()
    w, wn, rnorm = gls_solve_reference(**inp, sweeps=sweeps, rounds=rounds)
    w, wn, rnorm = w.numpy(), wn.numpy(), rnorm.numpy()
    act = np.asarray(tiles[8])[:128]
    assert act.sum() >= 8
    # the kernel's converged nodes: same weights, and converged here too
    conv = act & (rn_ref <= RNORM_TOL)
    scale = max(np.abs(w_ref[act]).max(), 1.0)
    assert np.abs(w[conv] - w_ref[conv]).max() / scale < TOL
    assert np.abs(wn[conv] - wn_ref[conv]).max() / scale < TOL
    assert (rnorm[conv] <= RNORM_TOL).all()
    # Interpret mode leaves a few well-conditioned nodes (cond ~ 35) at
    # rnorm ~ 1e-9 (its documented drift); ninpol_tpu sends them to the
    # exact path.  The port converges on them: hold them to dgels.
    flagged = np.nonzero(act & (rn_ref > RNORM_TOL))[0]
    if len(flagged):
        perm, dmag, nflag, nval = _fields(ref, case.name)
        Wo, NWo = gls_oracle(ref.grid, bucket["nodes"][flagged],
                             perm.reshape(-1, 9), dmag, nflag.astype(int),
                             nval, neumann_compat=False)
        k = w.shape[1]
        assert not Wo[:, k:].any()
        assert np.abs(w[flagged] - Wo[:, :k]).max() / scale < TOL
        assert np.abs(wn[flagged] - NWo).max() / scale < TOL
    # inactive rows are exactly zero
    assert not w[~act].any() and not rnorm[~act].any()


def test_plain_matches_pallas_kernel_on_neumann_tile(neumann_tile):
    """One 128-node Neumann tile of an ALH tetra_mesh(2): gls_solve_fused
    in interpret mode on its df32 planes vs gls_solve_reference on the
    same planes rebuilt as float64 (interop.tiles_from_reference), at the
    reference's 1e-10 bar."""
    _hold_to_interpret_kernel(neumann_tile, rounds=2, sweeps=3)


def test_plain_one_round_matches_pallas_kernel_on_neumann_tile(
        neumann_tile):
    """precond_rounds = 1 on the same tile: the TPU kernel's single-round
    preconditioner with its two more sweeps (ninpol_tpu gls.py:277) vs
    the plain version at rounds = 1, by the same rule."""
    _hold_to_interpret_kernel(neumann_tile, rounds=1, sweeps=5)


@pytest.mark.parametrize("neumann", [False, True])
def test_gather_and_solve_match_jax_composition(neumann):
    """A bucket of ninpol_tpu's plan through the port's own gather, solve
    and epilogue vs ninpol_tpu's _gls_bucket_impl(fused=False) — the JAX
    CPU composition of the same shifted-CholeskyQR2 algorithm — on the
    same state (interop.from_state)."""
    case, ref = _reference("tetra", 4)
    bucket, args = _ref_bucket(ref, case.name, neumann=neumann)
    E, F = bucket["E"], bucket["F"]
    w_ref, wn_ref, rn_ref = [np.asarray(x) for x in ref_gls._gls_bucket_kernel(
        *args, E=E, F=F, with_neumann=neumann, fused=False)]

    port = from_state(ref._make_cache(ref.process_mesh(ref.mesh_obj)),
                      device="cpu")
    dg = port.device_grid
    _, face_table, nflag_dev = port.gls.plan(
        dg, port.cells_data, port.points_data, port.variable_to_index,
        case.name, np.arange(port.grid.n_points))
    nodes = torch.as_tensor(bucket["nodes"].astype(np.int64))
    inp, n_elem = gls_gather(dg, face_table, nflag_dev, nodes, E, F, neumann)
    inp["valid"] = torch.as_tensor(bucket["valid"])
    w, wn, rn = gls_epilogue(*gls_solve(**inp), inp, n_elem, True)
    valid = bucket["valid"]
    assert valid.sum() >= 8
    scale = max(np.abs(w_ref).max(), 1.0)
    assert np.abs(w.numpy() - w_ref)[valid].max() / scale < TOL
    assert np.abs(wn.numpy() - wn_ref)[valid].max() / scale < TOL
    np.testing.assert_array_equal(rn.numpy()[valid] > RNORM_TOL,
                                  rn_ref[valid] > RNORM_TOL)


def _port_chunk(fam="tetra", n=3, neumann=False):
    """Solve inputs of one class chunk of the port's own plan."""
    case, ref = _reference(fam, n)
    port = ninpol_tpu_torch.Interpolator(device="cpu")
    port.load_mesh(mesh_obj=case.mesh)
    tp = np.arange(port.grid.n_points)
    classes, ft, nflag = port.gls.plan(
        port.device_grid, port.cells_data, port.points_data,
        port.variable_to_index, case.name, tp)
    c = [c for c in classes if c["with_neumann"] == neumann][0]
    nodes = torch.as_tensor(c["nodes"])
    inp, _ = gls_gather(port.device_grid, ft, nflag, nodes, c["E"], c["F"],
                        neumann)
    return inp


def test_clamped_pivot_forces_rnorm_one():
    """A rank-deficient node (every cell's x- and y-gradient columns made
    identical) breaks CholeskyQR2 down: round 2 clamps a pivot, the
    both-rounds guard max(dinv1, dinv1*dinv2) > 3e4 fires and rnorm is
    exactly 1 (the exact-fallback signal; its weights may overflow and
    are re-solved exactly).  Untouched nodes converge."""
    inp = _port_chunk()
    sick = inp["dk"].shape[0] // 2
    for key in ("dk", "l1", "l2", "t1m", "tt"):
        inp[key] = inp[key].clone()
        inp[key][sick, :, 1] = inp[key][sick, :, 0]
    w, wn, rnorm = gls_solve_reference(**inp)
    assert rnorm[sick].item() == 1.0
    others = torch.arange(len(rnorm)) != sick
    assert (rnorm[others] < RNORM_TOL).all()
    assert torch.isfinite(w[others]).all() and torch.isfinite(wn[others]).all()


def test_wrapper_rejects_bad_inputs():
    """The wrapper checks dtype, shape and device before any launch."""
    inp = _port_chunk()
    bad = dict(inp, dk=inp["dk"].float())
    with pytest.raises(ValueError, match="dk must be"):
        gls_solve(**bad)
    bad = dict(inp, ks=inp["ks"].long())
    with pytest.raises(ValueError, match="ks must be"):
        gls_solve(**bad)
    bad = dict(inp, cv=inp["cv"][:, :-1].contiguous())
    with pytest.raises(ValueError, match="cv must be"):
        gls_solve(**bad)
    bad = dict(inp, lb=inp["l1"])
    with pytest.raises(ValueError, match="lb and nm"):
        gls_solve(**bad)


def test_cpu_wrapper_runs_plain_version_without_counting():
    """On CPU tensors the wrapper IS the plain version, and counts no
    kernel launch."""
    inp = _port_chunk(neumann=True)
    before = gls_solve.launches
    a = gls_solve(**inp)
    b = gls_solve_reference(**inp)
    assert gls_solve.launches == before
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("neumann", [False, True])
def test_cuda_kernel_matches_plain_version(neumann):
    """The CUDA kernel against its plain version on the card, on the
    converged nodes; the fallback sets agree.  One node is made rank
    deficient as in test_clamped_pivot_forces_rnorm_one: the kernel, like
    the plain version, clamps a pivot there and forces its rnorm to 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel has no CPU mode)")
    inp = _port_chunk(n=4, neumann=neumann)
    sick = inp["dk"].shape[0] // 2
    for key in ("dk", "l1", "l2", "t1m", "tt") + (("lb",) if neumann else ()):
        inp[key] = inp[key].clone()
        inp[key][sick, :, 1] = inp[key][sick, :, 0]
    inp = {k: None if v is None else v.cuda() for k, v in inp.items()}
    before = gls_solve.launches
    wk, wnk, rk = gls_solve(**inp)
    assert gls_solve.launches == before + 1
    wp, wnp, rp = gls_solve_reference(**inp)
    assert rk[sick].item() == 1.0 and rp[sick].item() == 1.0
    conv = (rk <= RNORM_TOL) & (rp <= RNORM_TOL)
    assert conv.sum().item() >= len(rk) - 2
    # the sick node's weights may overflow: scale by the converged ones
    scale = max(wp[conv].abs().max().item(), 1.0)
    assert (wk - wp)[conv].abs().max().item() / scale < TOL
    assert (wnk - wnp)[conv].abs().max().item() / scale < TOL
    assert torch.equal(rk > RNORM_TOL, rp > RNORM_TOL)
