"""Manufactured-solution accuracy of the PyTorch port (on the CPU), as
test_accuracy.py:27-55 holds ninpol_tpu: linear exactness for LS and GLS,
second order for GLS and LS on hexa meshes, GLS converging on ALH
tetrahedra, IDW converging, and every case of tests/utils/cases.py
through GLS."""
import numpy as np
import pytest
import torch

import ninpol_tpu_torch
from ninpol_tpu.utils import meshgen
from tests.utils.cases import ALL_CASES, ALHCase, LINCase, QUADCase


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's default of one
    thread per core would oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_case(Case, fam, n, method, seed=0):
    case = Case()
    case.assign_mesh_properties(meshgen.FAMILIES[fam](n), seed=seed)
    interp = ninpol_tpu_torch.Interpolator(device="cpu")
    interp.load_mesh(mesh_obj=case.mesh)
    W, _ = interp.interpolate(case.name, method)
    return case.evaluate(W)


@pytest.mark.parametrize("fam", ["hexa", "tetra", "prism"])
@pytest.mark.parametrize("method", ["ls", "gls"])
def test_linear_exactness(fam, method):
    err = run_case(LINCase, fam, 3, method)
    assert err < 1e-12  # reference: ~3e-16 (mpfa.yaml:3-11)


@pytest.mark.parametrize("method,order_min", [("gls", 1.5), ("ls", 1.5)])
def test_quad_convergence_hexa(method, order_min):
    errs = [run_case(QUADCase, "hexa", n, method) for n in (4, 8)]
    order = np.log2(errs[0] / errs[1])
    assert order > order_min, f"errs={errs}, order={order:.2f}"


def test_alh_convergence_tetra():
    errs = [run_case(ALHCase, "tetra", n, "gls") for n in (4, 8)]
    order = np.log2(errs[0] / errs[1])
    assert order > 1.0, f"errs={errs}, order={order:.2f}"


def test_idw_is_first_order_ish():
    errs = [run_case(QUADCase, "hexa", n, "idw") for n in (4, 8)]
    assert errs[1] < errs[0]  # converging, sub-2nd order (reference Ru~0.7-1.5)


@pytest.mark.parametrize("Case", ALL_CASES)
def test_all_cases_run_gls(Case):
    err = run_case(Case, "mixed", 3, "gls")
    assert np.isfinite(err)
