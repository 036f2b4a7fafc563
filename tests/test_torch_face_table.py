"""The GLS face table's kernel (ninpol_tpu_torch/csrc/face_table.cu).  On
the CPU it runs through the emulator of tests/utils/cuda_emu (needs g++,
C++20): held to its plain version bit for bit, alone and standing in for
the card on the GLS main path, on one device and on a mesh, and under
chip_smoke.py's main path, which must see it launched.  On a card
(marked ``gpu``) the compiled kernel is held to the plain version the
same way."""
import contextlib
import functools
import os

import numpy as np
import pytest
import torch

import ninpol_tpu_torch
from ninpol_tpu_torch.ops import face_table as ft
from ninpol_tpu_torch.utils import meshgen, tracing
from tests.utils import cuda_emu


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's default of one
    thread per core would oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    if cuda_emu.gxx() is None:
        pytest.skip("needs g++ to build the emulated kernel")
    out = str(tmp_path_factory.mktemp("cuda_emu_face_table"))
    return cuda_emu.build("face_table", out, ft._bind)


def port(fam, n, **kwargs):
    interp = ninpol_tpu_torch.Interpolator(device="cpu", **kwargs)
    interp.load_mesh(mesh_obj=meshgen.FAMILIES[fam](n))
    return interp


def cpu_inputs(interp, seed=0):
    """face_table's arguments on the CPU: the grid's faces and a seeded
    non-symmetric K, diff_mag and Neumann values on some points."""
    dg = interp.device_grid
    n, p = dg.n_elems, dg.n_points
    rng = np.random.default_rng(seed)
    host = (rng.normal(size=9 * n), rng.random(n) * 3.0,
            rng.normal(size=p) * (rng.random(p) < 0.4))
    return [dg.face_geo, dg.esuf_pair, dg.inpofa] + [torch.as_tensor(a)
                                                     for a in host]


def bits(t):
    return t.view(torch.int64)


@pytest.mark.parametrize("fam,n", [("tetra", 3), ("hexa", 3), ("mixed", 3),
                                   ("triangle", 3), ("tetra", 5)])
def test_emulated_kernel_matches_plain_version(emu, fam, n):
    """The kernel's own code on the CPU, its table equal to the plain
    version's to the bit; tetra_mesh(5) spans seven 256-face tiles, the
    last one partial."""
    args = cpu_inputs(port(fam, n))
    geo, pair, inpofa, perm, dm, nv = args
    nf = geo.shape[0]
    out = torch.full((nf, ft.COLS), np.nan, dtype=torch.float64)
    assert emu.face_table_launch(
        geo.data_ptr(), pair.data_ptr(), inpofa.data_ptr(), inpofa.shape[1],
        perm.data_ptr(), dm.data_ptr(), nv.data_ptr(), out.data_ptr(), nf,
        None) == 0
    assert torch.equal(bits(out), bits(ft.face_table_reference(*args)))
    if (fam, n) == ("tetra", 5):
        assert nf > 6 * 256 and nf % 256


@pytest.fixture
def card(emu, monkeypatch):
    """The emulated kernel standing in for the card: ``face_table`` takes
    CPU tensors for a card's and launches it."""
    monkeypatch.setattr(ft.library, "lib", emu)
    monkeypatch.setattr(ft, "on_card", lambda x, name: True)
    monkeypatch.setattr(ft, "stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    return monkeypatch


@pytest.mark.parametrize("mesh,shard_geometry", [(None, False), (2, False),
                                                 (4, True)])
def test_emulated_kernel_on_the_main_path(card, monkeypatch, mesh,
                                          shard_geometry):
    """GLS weights with the face table built by the (emulated) kernel
    equal those built by the plain version, on one device and on a mesh
    (a replicated table, and one partitioned over four shards with a
    padded last part).  The kernel runs once a rebuild for each copy or
    part; the recorder's face_rows counts n_faces a rebuild, and none
    where the table is cached."""
    interp = port("tetra", 3, mesh=mesh, shard_geometry=shard_geometry)
    g = interp.grid
    rng = np.random.default_rng(3)
    flag = (np.asarray(g.boundary_points).astype(bool)
            & (rng.random(g.n_points) < 0.5)).astype(float)
    interp.load_data({"neumann_u": rng.normal(size=g.n_points) * flag,
                      "neumann_flag_u": flag}, "points")
    K = rng.normal(size=(g.n_elems, 3, 3))
    K = (K @ K.transpose(0, 2, 1) + np.eye(3)).reshape(-1, 9)
    u = np.sum(np.asarray(g.centroids) ** 2, axis=1)
    interp.load_data({"permeability": K, "u": u,
                      "diff_mag": interp.compute_diffusion_magnitude(K)},
                     "cells")
    tp = np.arange(g.n_points)
    monkeypatch.setenv("NINPOL_TPU_PHASES", "1")
    tracing.reset()
    launches = ft.face_table.launches
    W, NW = interp.prepare_interpolator("gls", "u", tp)
    placed = interp.device_grid.face_geo
    n_builds = len(placed.parts) if shard_geometry else 1
    assert not shard_geometry or g.n_faces % len(placed.parts)
    assert ft.face_table.launches == launches + n_builds
    assert tracing.snapshot()["counters"]["face_rows"] == g.n_faces
    interp.prepare_interpolator("gls", "u", tp, device_out=True)
    assert ft.face_table.launches == launches + n_builds
    assert tracing.snapshot()["counters"]["face_rows"] == g.n_faces
    card.undo()                          # the plain version, recorder off
    interp.load_data({"permeability": K, "u": u,
                      "diff_mag": interp.compute_diffusion_magnitude(K)},
                     "cells")
    W0, NW0 = interp.prepare_interpolator("gls", "u", tp)
    assert ft.face_table.launches == launches + n_builds
    np.testing.assert_array_equal(W, W0)
    np.testing.assert_array_equal(NW, NW0)


@pytest.mark.gpu
@pytest.mark.parametrize("family,n", [("tetra", 20), ("hexa", 16)])
def test_cuda_face_table_matches_plain_version(family, n):
    """The compiled kernel against its plain version on the same card
    tensors, to the bit: tetra_mesh(20)'s 98,400 faces end in a partial
    256-face tile, hexa_mesh(16)'s 13,056 fill 51 tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from ninpol_tpu_torch.tools import face_table as tool
    from ninpol_tpu_torch.tools.problem import build_problem

    interp, _ = build_problem(n, family=family)
    args = tool.inputs(interp)
    assert args[0].shape[0] == {"tetra": 98400, "hexa": 13056}[family]
    launches = ft.face_table.launches
    assert tool.differing_rows(args) == (0, 0.0)
    assert ft.face_table.launches == launches + 1


@pytest.mark.parametrize("mesh,shard_geometry", [(None, False), (4, True)])
def test_smoke_main_path_counts_a_table_a_run(card, monkeypatch, mesh,
                                              shard_geometry):
    """chip_smoke.py's main path loads the point data again before each of
    its five runs, so each rebuilds the face table by the (emulated)
    kernel: one launch a run on one device, one a part under
    shard_geometry, and no call of the plain version.  The "refined"
    route launches no other kernel, so no class is needed."""
    import chip_smoke
    from ninpol_tpu_torch import interpolator
    from ninpol_tpu_torch.tools.problem import build_problem

    monkeypatch.setattr(interpolator, "Interpolator", functools.partial(
        interpolator.Interpolator, device="cpu"))
    interp, _ = build_problem(3, shard_geometry=shard_geometry, mesh=mesh)
    interp.gls.solver = "refined"
    tables = chip_smoke.face_tables(interp)
    assert tables == (4 if shard_geometry else 1)
    tp = np.arange(interp.grid.n_points)
    W, NW, stats = chip_smoke.main_path(interp, tp, [], "refined",
                                        max_bad=None)
    assert stats["launches"]["face_table"] == 5 * tables
    assert all(n == 0 for k, n in stats["launches"].items()
               if k != "face_table")
    # the same weights as a run that built the table by the plain version
    card.undo()
    chip_smoke.reload_points(interp)
    W0, NW0 = interp.prepare_interpolator("gls", "u", tp)
    np.testing.assert_array_equal(W, W0)
    np.testing.assert_array_equal(NW, NW0)


def test_smoke_main_path_refuses_a_plain_table(monkeypatch):
    """On a grid whose face table is built by the plain version, as a
    regression that sent the card's table there would, the smoke's main
    path fails."""
    import chip_smoke
    from ninpol_tpu_torch import interpolator
    from ninpol_tpu_torch.tools.problem import build_problem

    monkeypatch.setattr(interpolator, "Interpolator", functools.partial(
        interpolator.Interpolator, device="cpu"))
    interp, _ = build_problem(3)
    interp.gls.solver = "refined"
    tp = np.arange(interp.grid.n_points)
    with pytest.raises(RuntimeError, match="'face_table': 0"):
        chip_smoke.main_path(interp, tp, [], "refined", max_bad=None)


def test_smoke_kernels_line_entry():
    """The face-table kernel's entry of chip_smoke.py's kernels line: phase
    4g's rows, the first mesh's numbers, the main path's launches."""
    import chip_smoke

    rows = [{"label": f"m{i}", "n_faces": 10 * i, "ms": 0.4 + i,
             "bound_ms": 0.25, "bound_by": "bytes", "plain_ms": 4.7,
             "max_abs_err": 0.0, "launches": 7} for i in range(2)]
    e = chip_smoke.face_table_entry(rows, 5)
    assert e["name"] == "face_table" and e["route"] == "cuda"
    assert e["source"] == "ninpol_tpu_torch/csrc/face_table.cu"
    assert e["launches"] == 5 and e["meshes"] == rows
    assert (e["ms"], e["plain_ms"], e["bound_ms"]) == (0.4, 4.7, 0.25)
    assert e["max_abs_err"] == 0.0 and e["library_ms"] is None
    path, line = e["replaces"].split(" ")[0].split(":")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, path)) as f:
        src = f.read().splitlines()
    assert src[int(line) - 1].startswith("def precompute_face_data(")
