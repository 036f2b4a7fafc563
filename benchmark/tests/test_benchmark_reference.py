"""The plain reference (benchmark/reference/gls.py) against the repository's
per-node dgels oracle (tests/utils/oracle.py::gls_oracle), which reads the
program's Grid.  The test compares; the reference never calls the
oracle, and imports nothing of the program."""
import subprocess
import sys

import numpy as np
import pytest

from benchmark.reference import gls as reference
from benchmark.yardstick import problem, topology
from ninpol_tpu_torch import Interpolator, Mesh
from ninpol_tpu_torch.utils import meshgen as port_meshgen
from tests.utils.oracle import gls_oracle

MESHES = {"hexa": lambda: port_meshgen.hexa_mesh(3),
          "tetra": lambda: port_meshgen.tetra_mesh(3),
          "prism": lambda: port_meshgen.prism_mesh(3),
          "mixed": lambda: port_meshgen.mixed_hexa_tetra_mesh(4)}


def flatten(mesh):
    """Points, -1 padded cells and a type name per cell."""
    n = sum(len(b.data) for b in mesh.cells)
    cells = np.full((n, 8), -1, np.int64)
    types, i = [], 0
    for b in mesh.cells:
        cells[i:i + len(b.data), :b.data.shape[1]] = b.data
        types += [b.type] * len(b.data)
        i += len(b.data)
    return np.asarray(mesh.points, np.float64), cells, np.asarray(types)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_reference_matches_the_dgels_oracle(name):
    mesh = MESHES[name]()
    points, cells, types = flatten(mesh)
    cents = topology.cell_centres(points, cells)
    K = problem.Field(77, 16, 1.0, 4.0, 1.0).perm(problem.alh_k(cents),
                                                   cents, 1)
    interp = Interpolator(device="cpu")
    interp.load_mesh(mesh_obj=Mesh(points, mesh.cells))
    g = interp.grid
    rng = np.random.default_rng(3)
    nflag = (np.asarray(g.boundary_points, bool)
             & (rng.uniform(size=len(points)) < 0.5)).astype(float)
    nval = rng.normal(size=len(points)) * nflag
    nodes = np.arange(len(points))
    around = reference.cells_around(cells, nodes)
    out = reference.gls_weights(points, cells, types, nodes, around,
                                lambda ids: K[ids], nflag, nval)
    W, Nw = gls_oracle(g, nodes, K.reshape(-1), problem.diff_mag(K), nflag,
                       nval)
    solved = 0
    for i, (ids, w, wn) in enumerate(out):
        assert np.array_equal(ids, g.esup[g.esup_ptr[i]:g.esup_ptr[i + 1]])
        top = np.abs(W[i]).max()
        scale = top if top > 0 else 1.0
        assert np.abs(W[i, :len(w)] - w).max() / scale < 1e-12
        assert abs(Nw[i] - wn) / scale < 1e-12
        solved += top > 0
    assert solved > len(points) // 2
    assert (nflag[[i for i, (_, w, wn) in enumerate(out) if wn]] > 0).all()


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.gls, benchmark.judge; "
            "import benchmark.yardstick.work; "
            "bad = {m.split('.')[0] for m in sys.modules} & {'jax', "
            "'jaxlib', 'flax', 'ninpol_tpu', 'ninpol_tpu_torch'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr
