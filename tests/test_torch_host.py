"""Host layer of the PyTorch port (ninpol_tpu_torch) vs ninpol_tpu: the
topology/geometry Grid, mesh I/O (test_interpolator.py's gmsh and VTK
checks among it), and the no-JAX import contract."""
import os
import subprocess
import sys

import numpy as np
import pytest

import ninpol_tpu
import ninpol_tpu_torch
from ninpol_tpu.utils import meshgen as ref_meshgen
from ninpol_tpu_torch._io import mesh as mio
from ninpol_tpu_torch.utils import meshgen
from tests.utils.cases import LINCase

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grid_data(pkg, mesh):
    interp = pkg.Interpolator()
    interp.load_mesh(mesh_obj=mesh)
    return interp.grid.get_data()


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("fam", sorted(meshgen.FAMILIES))
def test_grid_data_equals_reference(fam, n):
    """Every Grid.get_data() entry is bit-equal to ninpol_tpu's on the
    same generated mesh (the host layer is a copy; the native build is
    the port's own, with the same -ffp-contract=off)."""
    ref = _grid_data(ninpol_tpu, ref_meshgen.FAMILIES[fam](n))
    port = _grid_data(ninpol_tpu_torch, meshgen.FAMILIES[fam](n))
    assert ref.keys() == port.keys()
    for key in ref:
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)


@pytest.mark.parametrize("fmt,binary,ver", [
    ("msh", False, "2.2"), ("msh", True, "2.2"),
    ("msh", False, "4.1"), ("msh", True, "4.1"),
    ("vtk", False, "-"), ("vtk", True, "-"),
])
def test_mesh_io_roundtrip(fmt, binary, ver, tmp_path):
    """Write + read back with the port's I/O; ninpol_tpu reads the same
    file to the same mesh."""
    mesh = meshgen.mixed_hexa_tetra_mesh(2)
    path = str(tmp_path / f"m.{fmt}")
    kw = {"msh_version": ver} if fmt == "msh" else {}
    mio.write(path, mesh, binary=binary, **kw)
    for back in (mio.read(path), ninpol_tpu.read_mesh(path)):
        np.testing.assert_array_equal(back.points, mesh.points)
        d1 = {b.type: b.data for b in mesh.cells}
        d2 = {b.type: b.data for b in back.cells}
        assert d1.keys() == d2.keys()
        for t in d1:
            np.testing.assert_array_equal(d1[t], d2[t])


def test_gmsh2_noncontiguous_tags(tmp_path):
    """v2.2 files with sparse node tags remap connectivity consistently
    (test_interpolator.py:97)."""
    path = str(tmp_path / "gap.msh")
    # tags 10, 20, 30, 40 (sorted order = tag order here)
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n4\n"
                "10 0 0 0\n20 1 0 0\n30 0 1 0\n40 0 0 1\n$EndNodes\n"
                "$Elements\n1\n1 4 2 0 0 10 20 30 40\n$EndElements\n")
    m = mio.read(path)
    assert m.cells[0].type == "tetra"
    assert np.array_equal(m.cells[0].data, [[0, 1, 2, 3]])
    assert np.allclose(m.points, [[0, 0, 0], [1, 0, 0],
                                  [0, 1, 0], [0, 0, 1]])


def test_vtk_binary_data_roundtrip(tmp_path):
    """Cell and point data survive a binary VTK round trip
    (test_interpolator.py:114)."""
    mesh = meshgen.tetra_mesh(2)
    n_cells = sum(len(b) for b in mesh.cells)
    rng = np.random.default_rng(0)
    mesh.cell_data = {"perm": [rng.standard_normal((n_cells, 9))]}
    mesh.point_data = {"u": rng.standard_normal(len(mesh.points))}
    path = str(tmp_path / "d.vtk")
    mio.write(path, mesh, binary=True)
    back = mio.read(path)
    assert np.allclose(back.cell_data_dict["perm"]["tetra"],
                       mesh.cell_data["perm"][0])
    assert np.allclose(back.point_data["u"], mesh.point_data["u"])


def test_vtk_data_roundtrip():
    """A case's data rides the port's Mesh object in meshio's layout
    (test_interpolator.py:128: the VTK writer keeps geometry only); the
    case's mesh is ninpol_tpu's, which the port takes by duck typing."""
    case = LINCase()
    case.assign_mesh_properties(ref_meshgen.hexa_mesh(2), seed=0)
    m = mio.as_local_mesh(case.mesh)
    assert isinstance(m, mio.Mesh)
    assert "permeability" in m.cell_data
    assert m.cell_data_dict["permeability"]["hexahedron"].shape[1] == 9
    assert "neumann_flag_LIN" in m.point_data


def test_load_mesh_file_uses_own_pickle_cache(tmp_path):
    """A file load writes a pickle cache under the port's own prefix (so
    the two packages never load each other's pickled Grid), and a second
    load from it gives the same grid."""
    path = str(tmp_path / "c.vtk")
    ninpol_tpu_torch.write_mesh(path, meshgen.tetra_mesh(2))
    a = ninpol_tpu_torch.Interpolator()
    a.CACHE_PATH = str(tmp_path)
    a.load_mesh(path)
    cache = a.is_cached(path)
    assert cache and os.path.basename(cache).startswith("ninpol_tpu_torch_")
    b = ninpol_tpu_torch.Interpolator()
    b.CACHE_PATH = str(tmp_path)
    b.load_mesh(path)
    da, db = a.grid.get_data(), b.grid.get_data()
    for key in da:
        np.testing.assert_array_equal(da[key], db[key], err_msg=key)


def test_import_leaves_jax_out():
    """import ninpol_tpu_torch (and its interop module) loads no JAX and
    no ninpol_tpu, and turns TF32 off."""
    code = ("import sys, torch, ninpol_tpu_torch, ninpol_tpu_torch.interop;"
            "assert 'jax' not in sys.modules, 'jax imported';"
            "assert 'ninpol_tpu' not in sys.modules, 'ninpol_tpu imported';"
            "assert not torch.backends.cuda.matmul.allow_tf32;"
            "assert not torch.backends.cudnn.allow_tf32")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_port_sources_name_no_jax():
    """No module of the port imports jax or ninpol_tpu."""
    pkg = os.path.join(ROOT, "ninpol_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                for line in f:
                    words = line.split()
                    if words[:1] in (["import"], ["from"]) and len(words) > 1:
                        mod = words[1].split(".")[0]
                        assert mod not in ("jax", "ninpol_tpu"), \
                            f"{name}: {line.strip()}"
