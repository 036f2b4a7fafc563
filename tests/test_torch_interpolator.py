"""The PyTorch port's Interpolator surface (on the CPU), as
test_interpolator.py:45-262 holds ninpol_tpu's: error paths, repeated
interpolate() calls, cache invalidation by load_data and by the GLS
settings, device_out for every method, face and point data management,
the mesh-file cache, and face_data_to_node against ninpol_tpu's."""
import os

import numpy as np
import pytest
import torch

import ninpol_tpu_torch
from ninpol_tpu.utils import meshgen
from ninpol_tpu.utils.face_data_to_node import \
    face_data_to_node as ref_face_data_to_node
from ninpol_tpu_torch._io import mesh as mio
from ninpol_tpu_torch.utils.face_data_to_node import face_data_to_node
from tests.utils.cases import ALHCase, LINCase


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's default of one
    thread per core would oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup(fam="hexa", n=3, Case=ALHCase):
    case = Case()
    case.assign_mesh_properties(meshgen.FAMILIES[fam](n), seed=0)
    interp = ninpol_tpu_torch.Interpolator(device="cpu")
    interp.load_mesh(mesh_obj=case.mesh)
    return case, interp


def test_csr_assembly_semantics():
    case, interp = setup()
    grid = interp.grid
    tp = np.arange(grid.n_points)
    Wm, NW = interp.prepare_interpolator("gls", case.name, tp)
    Wcsr, NW2 = interp.interpolate(case.name, "gls")
    assert np.array_equal(NW, NW2)
    assert Wcsr.shape == (grid.n_points, grid.n_elems)
    # per reference interpolator.pyx:612-618: entry = weight + neumann_ws
    dense = Wcsr.toarray()
    for p in range(0, grid.n_points, 5):
        elems = grid.esup[grid.esup_ptr[p]:grid.esup_ptr[p + 1]]
        expect = Wm[p, :len(elems)] + NW[p]
        assert np.allclose(dense[p, elems], expect, atol=1e-15)
    dirichlet = (grid.boundary_points.astype(bool)
                 & (interp.points_data[interp.variable_to_index["points"][
                     f"neumann_flag_{case.name}"]] == 0))
    assert np.abs(dense[dirichlet]).max() == 0


def test_interpolate_errors():
    case, interp = setup()
    assert set(interp.supported_methods) == {"gls", "idw", "ls"}
    with pytest.raises(ValueError, match="not supported"):
        interp.interpolate(case.name, "nope")
    with pytest.raises(ValueError, match="not found"):
        interp.interpolate("missing_var", "idw")
    fresh = ninpol_tpu_torch.Interpolator(device="cpu")
    with pytest.raises(ValueError, match="Grid not initialized"):
        fresh.interpolate("x", "idw")
    with pytest.raises(ValueError, match="must be"):
        fresh.load_mesh()


def test_mesh_file_cache_roundtrip(tmp_path):
    case = LINCase()
    case.assign_mesh_properties(meshgen.hexa_mesh(3), seed=0)
    path = str(tmp_path / "m.vtk")
    mio.write(path, case.mesh)
    i1 = ninpol_tpu_torch.Interpolator(device="cpu")
    i1.CACHE_PATH = str(tmp_path)
    i1.load_mesh(path)
    assert i1.is_cached(path)
    W1, _ = i1.interpolate("LIN", "gls")
    i2 = ninpol_tpu_torch.Interpolator(device="cpu")
    i2.CACHE_PATH = str(tmp_path)
    i2.load_mesh(path)  # from cache
    W2, _ = i2.interpolate("LIN", "gls")
    assert np.abs((W1 - W2).toarray()).max() == 0
    os.remove(i1.is_cached(path))


def test_repeated_interpolate_identical():
    """Back-to-back interpolate() calls (fresh prepare each time) are
    identical: eliminate_zeros() compacts CSR indices in place, so the
    cached column pattern must never be handed to it directly."""
    case, interp = setup(Case=LINCase)
    W1, _ = interp.interpolate(case.name, "idw")
    interp._prep_cache = {}
    W2, _ = interp.interpolate(case.name, "idw")
    assert (W1 != W2).nnz == 0
    assert np.array_equal(W1.indices, W2.indices)


def test_load_data_invalidates_cached_weights():
    """Reloading cell data (new permeability) invalidates the GLS face
    table and the prepared weights: the new weights are a fresh
    interpolator's."""
    case, interp = setup(fam="tetra", n=3)
    tp = np.arange(interp.grid.n_points)
    W1, _ = interp.prepare_interpolator("gls", case.name, tp)
    M1, _ = interp.interpolate(case.name, "gls")
    v2i = interp.variable_to_index["cells"]
    n_elems = interp.grid.n_elems
    perm = interp.cells_data[v2i["permeability"]][:n_elems * 9] \
        .reshape(-1, 3, 3).copy()
    perm[:, 0, 0] *= 3.0
    sol = interp.cells_data[v2i[case.name]][:n_elems].copy()
    dmag = interp.compute_diffusion_magnitude(perm.reshape(-1, 9))
    new = {"permeability": perm.reshape(-1, 9), case.name: sol,
           "diff_mag": dmag}
    interp.load_data(new, "cells")
    W2, _ = interp.prepare_interpolator("gls", case.name, tp)
    M2, _ = interp.interpolate(case.name, "gls")
    assert np.abs(W1 - W2).max() > 1e-8
    assert np.abs((M1 - M2).toarray()).max() > 1e-8
    fresh = ninpol_tpu_torch.Interpolator(device="cpu")
    fresh.load_mesh(mesh_obj=case.mesh)
    fresh.load_data(new, "cells")
    W3, _ = fresh.prepare_interpolator("gls", case.name, tp)
    assert np.abs(W2 - W3).max() < 1e-12


def test_gls_settings_invalidate_prep_cache():
    """interpolate()'s prepared-weights cache key holds every GLS setting
    that changes the result."""
    case, interp = setup(fam="tetra", n=3)
    interp.interpolate(case.name, "gls")
    for name, value in (("n_refine", 5), ("fallback_tol", 1e-9),
                        ("solver", "refined"), ("precond_rounds", 1),
                        ("neumann_compat", False), ("exact", True)):
        keys = set(interp._prep_cache)
        setattr(interp.gls, name, value)
        interp.interpolate(case.name, "gls")
        assert set(interp._prep_cache) - keys, \
            f"changed {name} must miss the prep cache"


@pytest.mark.parametrize("method", ["gls", "idw", "ls"])
def test_device_out_matches_host(method):
    """prepare_interpolator(device_out=True) returns [weights | neumann]
    as a float64 tensor on the device, equal to the host contract; IDW and
    LS leave the Neumann column zero (idw.pyx/ls.pyx never write it)."""
    case, interp = setup("tetra", 3, LINCase)
    tp = np.arange(interp.grid.n_points)
    W, NW = interp.prepare_interpolator(method, case.name, tp)
    dev = interp.prepare_interpolator(method, case.name, tp,
                                      device_out=True)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float64
    assert dev.shape == (len(tp), W.shape[1] + 1)
    np.testing.assert_array_equal(dev[:, :-1].numpy(), W)
    np.testing.assert_array_equal(dev[:, -1].numpy(), NW)
    if method != "gls":
        assert not NW.any()


def test_load_face_data():
    case, interp = setup()
    grid = interp.grid
    vals = np.arange(grid.n_faces, dtype=float)[:, None]
    interp.load_face_data({"flux": vals})
    assert np.array_equal(interp.faces_data[0], vals[:, 0])
    perm = np.random.default_rng(0).permutation(grid.n_faces)
    conn = grid.inpofa[perm]
    interp.load_face_data({"flux": vals[perm]}, face_connectivity=conn)
    assert np.allclose(interp.faces_data[0], vals[:, 0])
    bad = conn.copy()
    bad[0] = bad[0][::-1]
    with pytest.raises(ValueError, match="does not match"):
        interp.load_face_data({"flux": vals[perm]}, face_connectivity=bad)


def test_get_data_and_dict():
    case, interp = setup()
    d = interp.get_dict()
    assert "variable_to_index" in d
    idx = np.arange(4)
    vals = interp.get_data("cells", idx, "diff_mag")
    assert vals.shape == (4,)
    pv = interp.get_data("points", idx, f"neumann_flag_{case.name}")
    assert pv.shape == (4,)
    with pytest.raises(ValueError):
        interp.get_data("cells", idx, "nope")


@pytest.mark.parametrize("method", ["idw", "ls", "gls"])
def test_vector_data_rejected(method):
    case, interp = setup()
    with pytest.raises(ValueError, match="more than one dimension"):
        interp.interpolate("permeability", method)


@pytest.mark.parametrize("mode", ["mean", "idw"])
def test_face_data_to_node_matches_reference(mode):
    """The port's copy of face_data_to_node against ninpol_tpu's, on
    scalar and vector face data; a constant is kept by the mean and a
    linear field approximated to mesh-width accuracy (the behaviour
    test_interpolator.py:255 checks)."""
    _, interp = setup("hexa", 3)
    grid = interp.grid
    rng = np.random.default_rng(0)
    const = np.full(grid.n_faces, 7.5)
    lin = grid.faces_centers.sum(axis=1)
    vec = np.stack([lin, rng.standard_normal(grid.n_faces)], axis=1)
    for vals in (const, lin, vec):
        out = face_data_to_node(grid, vals, method=mode)
        np.testing.assert_array_equal(
            out, ref_face_data_to_node(grid, vals, method=mode))
    assert out.shape == (grid.n_points, 2)
    assert np.allclose(face_data_to_node(grid, const, method=mode), 7.5)
    err = face_data_to_node(grid, lin, method=mode) - \
        grid.point_coords.sum(axis=1)
    assert np.abs(err).max() < 0.35
    with pytest.raises(ValueError, match="Unknown method"):
        face_data_to_node(grid, const, method="nope")
