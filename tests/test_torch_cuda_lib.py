"""The build key of the port's CUDA libraries (ops/cuda_lib.py): a library
is named by the content of its source and of every csrc/*.cuh header, so
an edited header rebuilds it and an unchanged tree reuses it.  Needs no
nvcc: only the names are computed."""
import os

import pytest

from ninpol_tpu_torch.ops import cuda_lib
from ninpol_tpu_torch.ops.cuda_lib import CudaLibrary, source_digest


@pytest.fixture
def csrc(tmp_path):
    """A kernel directory with one source that includes one header."""
    (tmp_path / "k.cu").write_text('#include "dev.cuh"\nint f();\n')
    (tmp_path / "dev.cuh").write_text("inline int g() { return 1; }\n")
    return tmp_path


def _digest(csrc):
    return source_digest(str(csrc / "k.cu"), str(csrc))


def test_unchanged_tree_gives_the_same_digest(csrc):
    first = _digest(csrc)
    assert _digest(csrc) == first
    os.utime(csrc / "dev.cuh")        # touched, content unchanged
    assert _digest(csrc) == first


@pytest.mark.parametrize("edit", ["header", "new_header", "source",
                                  "renamed_header"])
def test_any_edit_changes_the_digest(csrc, edit):
    first = _digest(csrc)
    if edit == "header":
        (csrc / "dev.cuh").write_text("inline int g() { return 2; }\n")
    elif edit == "new_header":
        (csrc / "more.cuh").write_text("// another header\n")
    elif edit == "source":
        (csrc / "k.cu").write_text('#include "dev.cuh"\nint f(int);\n')
    else:
        os.rename(csrc / "dev.cuh", csrc / "dev2.cuh")
    assert _digest(csrc) != first


def test_library_path_follows_the_header(csrc):
    """The .so a CudaLibrary would load changes with its header."""
    lib = CudaLibrary("k", bind=None, csrc=str(csrc))
    before = lib.path()
    assert os.path.dirname(before) == cuda_lib.BUILD_DIR
    assert os.path.basename(before) == f"k_{_digest(csrc)}.so"
    assert lib.path() == before
    (csrc / "dev.cuh").write_text("inline int g() { return 3; }\n")
    assert lib.path() != before


def test_package_libraries_hash_the_shared_header():
    """The package's own kernels: the sources that include a csrc/ header
    are named by a digest that covers it."""
    from ninpol_tpu_torch.ops import cholqr, gls_solve, qr

    header = os.path.join(cuda_lib.CSRC, "cholqr_device.cuh")
    assert os.path.exists(header)
    for mod in (cholqr, gls_solve, qr):
        lib = mod.library
        assert lib.path().endswith(
            f"{lib.name}_{source_digest(lib.source)}.so")
    for mod in (cholqr, gls_solve):
        with open(mod.library.source) as f:
            assert '#include "cholqr_device.cuh"' in f.read()


def test_define_builds_a_library_of_its_own(csrc):
    """A library built with a macro from the same source has a name of its
    own (so neither build replaces the other) that follows the source's
    digest; the solve kernel's stage cuts are such a library."""
    from ninpol_tpu_torch.ops import gls_solve

    plain = CudaLibrary("k", bind=None, csrc=str(csrc))
    cuts = CudaLibrary("k", bind=None, csrc=str(csrc), define="CUTS")
    assert os.path.basename(cuts.path()) == f"k-CUTS_{_digest(csrc)}.so"
    assert cuts.path() != plain.path()
    assert (cuts.source, cuts.label) == (plain.source, "k.cu -DCUTS")
    before = cuts.path()
    (csrc / "dev.cuh").write_text("inline int g() { return 3; }\n")
    assert cuts.path() != before
    stages, prod = gls_solve.stage_library, gls_solve.library
    assert stages.source == prod.source and stages.path() != prod.path()
    assert stages.define == "GLS_SOLVE_STAGE_CUTS" and prod.define is None


@pytest.mark.parametrize("header,users", [
    ("cholqr_device.cuh", ("cholqr", "gls_solve")),
    ("blocked_factor.cuh", ("gls_solve", "factor_probes")),
])
def test_editing_a_package_header_renames_its_users(tmp_path, header, users):
    """Each csrc/ header shared by two libraries: both sources include it,
    and an edit of it alone renames both libraries (the stage cuts'
    too), so a card builds them anew."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC, csrc)
    libs = [CudaLibrary(name, bind=None, csrc=str(csrc), define=define)
            for name in users
            for define in ((None, "GLS_SOLVE_STAGE_CUTS")
                           if name == "gls_solve" else (None,))]
    for lib in libs:
        with open(lib.source) as f:
            assert f'#include "{header}"' in f.read()
    before = [lib.path() for lib in libs]
    with open(csrc / header, "a") as f:
        f.write("// edited\n")
    assert all(lib.path() != p for lib, p in zip(libs, before))
