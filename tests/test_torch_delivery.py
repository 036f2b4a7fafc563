"""Host delivery settings of the PyTorch port against ninpol_tpu's, on the
CPU: ``Interpolator.delivery_f32`` (the delivered rows cast to float32
on the device, tests/test_delivery.py's bar: equal to the float64 result
cast to float32, bit for bit), on one device and on a two-shard mesh,
and ``shard_geometry``, which both packages drop without a mesh."""
import numpy as np
import pytest
import torch

import ninpol_tpu
import ninpol_tpu_torch
from ninpol_tpu.utils import meshgen
from tests.utils.cases import ALHCase


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's default of one
    thread per core would oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    case = ALHCase()
    case.assign_mesh_properties(meshgen.tetra_mesh(3), seed=0)
    return case


@pytest.fixture(scope="module")
def interps(case):
    """The port on one CPU device and on a two-shard CPU mesh."""
    out = {}
    for mesh in (None, 2):
        interp = ninpol_tpu_torch.Interpolator(device="cpu", mesh=mesh)
        interp.load_mesh(mesh_obj=case.mesh)
        out[mesh] = interp
    return out


@pytest.mark.parametrize("mesh", [None, 2])
@pytest.mark.parametrize("method", ["gls", "idw", "ls"])
def test_delivery_f32_rounds_the_float64_result(case, interps, method,
                                                mesh):
    """With delivery_f32 the host weights and Neumann vector are the
    float64 ones cast to float32, bit for bit, in float64 arrays; on a
    mesh the rows are cast on the primary device after the merge."""
    interp = interps[mesh]
    tp = np.arange(interp.grid.n_points)
    W64, N64 = interp.prepare_interpolator(method, case.name, tp)
    interp.delivery_f32 = True
    try:
        W32, N32 = interp.prepare_interpolator(method, case.name, tp)
    finally:
        interp.delivery_f32 = False
    assert W32.dtype == N32.dtype == np.float64
    np.testing.assert_array_equal(W32, W64.astype(np.float32))
    np.testing.assert_array_equal(N32, N64.astype(np.float32))
    assert not np.array_equal(W32, W64)      # it did round
    if method == "gls":
        assert np.abs(N64).max() > 0 and not np.array_equal(N32, N64)


def test_delivery_f32_is_part_of_the_cache_key(case, interps):
    """interpolate() caches prepared weights: toggling delivery_f32
    without a reload gives the other setting's result, and back;
    device_out=True stays float64 whatever it says."""
    interp = interps[None]
    tp = np.arange(interp.grid.n_points)
    M64, neu64 = interp.interpolate(case.name, "gls")
    interp.delivery_f32 = True
    try:
        M32, neu32 = interp.interpolate(case.name, "gls")
        wdev = interp.prepare_interpolator("gls", case.name, tp,
                                           device_out=True)
    finally:
        interp.delivery_f32 = False
    W, N = interp.prepare_interpolator("gls", case.name, tp)
    np.testing.assert_array_equal(neu32, N.astype(np.float32))
    assert not np.array_equal(M32.data, M64.data)
    assert np.abs(M32.data - M64.data).max() < 1e-6 * np.abs(M64.data).max()
    M, neu = interp.interpolate(case.name, "gls")
    np.testing.assert_array_equal(M.data, M64.data)
    np.testing.assert_array_equal(neu, neu64)
    assert wdev.dtype == torch.float64
    np.testing.assert_array_equal(wdev[:, :-1].numpy(), W)
    np.testing.assert_array_equal(wdev[:, -1].numpy(), N)


@pytest.mark.parametrize("mesh", [None, 1])
def test_shard_geometry_follows_ninpol_tpu(mesh):
    """Interpolator(shard_geometry=True) keeps the setting only with a
    mesh, in both packages; without one the port keeps its default
    (fused) route, and gls.fused = False is its switch to the unfused
    route on one device."""
    ref = ninpol_tpu.Interpolator(mesh=mesh, shard_geometry=True)
    port = ninpol_tpu_torch.Interpolator(device="cpu", mesh=mesh,
                                         shard_geometry=True)
    assert port.shard_geometry == ref.shard_geometry == (mesh is not None)
    assert port.gls.fused == (mesh is None)
    assert port.gls.route() == ("fused" if mesh is None else "unfused")
