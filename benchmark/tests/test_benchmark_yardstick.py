"""The benchmark's frozen yardstick, on the CPU: its meshes, topology,
problem, realizations and work count.  Run from the repository's root:
``python -m pytest benchmark/tests -q``."""
import numpy as np
import pytest
import torch

from benchmark.yardstick import meshgen, problem, topology, work
from ninpol_tpu_torch import Interpolator, Mesh
from ninpol_tpu_torch.utils import meshgen as port_meshgen

PORT = {"hexa": port_meshgen.hexa_mesh, "tetra": port_meshgen.tetra_mesh,
        "prism": port_meshgen.prism_mesh}


def grid_of(points, cells, cell_type):
    interp = Interpolator(device="cpu")
    interp.load_mesh(mesh_obj=Mesh(points, [(cell_type, cells)]))
    return interp.grid


@pytest.mark.parametrize("family", sorted(meshgen.FAMILIES))
@pytest.mark.parametrize("n", [1, 2, 3])
def test_meshes_equal_the_programs(family, n):
    points, cells, cell_type = meshgen.FAMILIES[family](n)
    port = PORT[family](n)
    assert port.cells[0].type == cell_type
    assert np.array_equal(points, port.points)
    assert np.array_equal(cells, port.cells[0].data)


@pytest.mark.parametrize("family", sorted(meshgen.FAMILIES))
def test_topology_counts_match_the_programs_grid(family):
    points, cells, cell_type = meshgen.FAMILIES[family](3)
    topo = topology.mesh_faces(torch.as_tensor(cells), cell_type,
                               len(points))
    g = grid_of(points, cells, cell_type)
    assert topo["n_faces"] == g.n_faces
    assert np.array_equal(topo["n_elem"], np.diff(g.esup_ptr))
    assert np.array_equal(topo["n_face"], np.diff(g.fsup_ptr))
    bfaces = np.flatnonzero(g.boundary_faces)
    assert len(topo["bface_cell"]) == len(bfaces)
    # the same boundary faces, each with its owner and its point order
    # (the order the program's normals are taken in)
    ours = {tuple(p): c for p, c in zip(topo["bface_points"].tolist(),
                                        topo["bface_cell"].tolist())}
    theirs = {tuple(g.inpofa[f].tolist()): int(g.esuf[g.esuf_ptr[f]])
              for f in bfaces}
    assert ours == theirs
    fp = topo["bface_points"]
    order = [np.flatnonzero((g.inpofa[bfaces] == p).all(axis=1))[0]
             for p in fp]
    assert np.array_equal(topology.face_normals(points, fp),
                          g.normal_faces[bfaces[order]])
    assert np.allclose(topology.face_centers(points, fp),
                       g.faces_centers[bfaces[order]], rtol=0, atol=1e-15)


@pytest.mark.parametrize("family,E,F", [("tetra", 24, 36), ("hexa", 8, 12)])
def test_work_count_of_one_interior_node(family, E, F):
    points, cells, cell_type = meshgen.FAMILIES[family](4)
    topo = topology.mesh_faces(torch.as_tensor(cells), cell_type,
                               len(points))
    v = 2 * 25 + 2 * 5 + 2                  # the lattice's centre point
    assert (topo["n_elem"][v], topo["n_face"][v], topo["n_bface"][v]) == (
        E, F, 0)
    one = {k: topo[k][[v]] for k in ("n_elem", "n_face", "n_bface")}
    flops, nbytes = work.gls_work(one, np.zeros(1))
    m, n = E + 3 * F, 3 * E + 1
    # by hand: (24, 36) m 132 n 73; (8, 12) m 44 n 25
    assert (m, n) == ((132, 73) if E == 24 else (44, 25))
    assert flops == pytest.approx(2 * m * n * n - 2 * n ** 3 / 3, rel=1e-15)
    assert nbytes == 8 * (3 * E + 14 * F + E + 2)
    ms, by = work.least_ms(flops, nbytes)
    assert by == "operations"
    assert ms == pytest.approx(flops / 67e12 * 1e3)


def test_work_counts_solved_nodes_only():
    points, cells, cell_type = meshgen.tetra(3)
    topo = topology.mesh_faces(torch.as_tensor(cells), cell_type,
                               len(points))
    K = problem.alh_k(topology.cell_centres(points, cells))
    nflag, _ = problem.boundary_problem(points, topo, K, 5)
    solved = work.solved_nodes(topo, nflag)
    boundary = topo["n_bface"] > 0
    assert solved[~boundary].all()
    assert not solved[boundary & (nflag == 0)].any()
    assert solved[boundary & (nflag > 0)].any()
    with_neumann = work.gls_work(topo, nflag)[0]
    assert with_neumann > work.gls_work(topo, np.zeros_like(nflag))[0]


def test_rebuilds_never_share_a_realization():
    points, cells, _ = meshgen.tetra(3)
    cents = topology.cell_centres(points, cells)
    K = problem.alh_k(cents)
    field = problem.Field(2 ** 31 + 11, 16, 1.0, 4.0, 1.0)
    perms = [field.perm(K, cents, r) for r in range(6)]
    for i in range(len(perms)):
        for j in range(i):
            assert not np.any(perms[i] == perms[j])
    again = problem.Field(2 ** 31 + 11, 16, 1.0, 4.0, 1.0)
    assert np.array_equal(again.perm(K, cents, 3), perms[3])
    other = problem.Field(2 ** 31 + 12, 16, 1.0, 4.0, 1.0)
    assert not np.any(other.perm(K, cents, 3) == perms[3])
    # a subset of cells reads the same bits, on numpy and on torch
    ids = np.array([5, 17, 40])
    assert np.array_equal(field.perm(K[ids], cents[ids], 3), perms[3][ids])
    t = field.perm(torch.as_tensor(K), torch.as_tensor(cents), 3).numpy()
    t_sub = field.perm(torch.as_tensor(K[ids]), torch.as_tensor(cents[ids]),
                       3).numpy()
    assert np.array_equal(t[ids], t_sub)
    assert np.allclose(t, perms[3], rtol=1e-14, atol=0)


def test_field_has_unit_variance_and_spd_permeability():
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(20000, 3))
    gs = [problem.Field(s, 16, 1.0, 4.0, 1.0).g(x, r)
          for s in range(20) for r in range(5)]
    var = np.mean([np.var(g) for g in gs])
    assert 0.7 < var < 1.3
    K = problem.Field(1, 16, 1.0, 4.0, 1.0).perm(problem.alh_k(x), x, 0)
    assert (np.linalg.eigvalsh(K.reshape(-1, 3, 3)) > 0).all()


def test_boundary_problem_follows_bench_py():
    points, cells, cell_type = meshgen.hexa(3)
    topo = topology.mesh_faces(torch.as_tensor(cells), cell_type,
                               len(points))
    K = problem.alh_k(topology.cell_centres(points, cells))
    nflag, nval = problem.boundary_problem(points, topo, K, 123)
    boundary = topo["n_bface"] > 0
    assert nflag[boundary].any() and not nflag[~boundary].any()
    assert not np.any(nval[nflag == 0])
    again = problem.boundary_problem(points, topo, K, 123)
    assert np.array_equal(again[0], nflag) and np.array_equal(again[1], nval)
    # bench.py's Neumann value: the mean over the point's faces of the
    # boundary faces' -(K grad u).n, u = |x|^2, with the owner's K
    g = grid_of(points, cells, cell_type)
    p = int(np.flatnonzero(nflag)[0])
    faces = g.fsup[g.fsup_ptr[p]:g.fsup_ptr[p + 1]]
    total = 0.0
    for f in faces[g.boundary_faces[faces] == 1]:
        owner = g.esuf[g.esuf_ptr[f]]
        flux = -K[owner].reshape(3, 3) @ (2 * g.faces_centers[f])
        total += flux @ g.normal_faces[f]
    assert nval[p] == pytest.approx(total / len(faces), rel=1e-13)
