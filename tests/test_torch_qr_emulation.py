"""The CSNE kernels of the PyTorch port (ninpol_tpu_torch/csrc/qr.cu) on
the CPU, through the emulator of tests/utils/cuda_emu, against their
plain PyTorch versions; and the
contract of ``qr_r`` (R of [A; diag(dead)] from A alone) against
ninpol_tpu's Pallas kernel fed the appended rows, as its route builds
them.  On a card chip_smoke.py holds the compiled kernels to the same
versions.  Needs g++ (C++20) for the emulated kernels."""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ninpol_tpu.ops import pallas_qr
from ninpol_tpu_torch.ops import qr
from tests.utils import cuda_emu

# R of the kernel against the plain version, entry by entry, scaled per
# node by max|R|: both follow one sign convention, so only the order of
# the sums differs
R_TOL = 1e-12
QR_RATIO = 10.0     # backward error and residual: at most this x plain


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if cuda_emu.gxx() is None:
        pytest.skip("needs g++ to build the emulated kernels")
    return cuda_emu.build("qr", str(tmp_path_factory.mktemp("cuda_emu")),
                          qr._bind)


def _call(fn, *args):
    assert fn(*[x.data_ptr() if isinstance(x, torch.Tensor) else x
                for x in args], None) == 0


def emu_qr_r(lib, A, path=0, workspace=False):
    """The emulated kernel as ops/qr.py::qr_r launches it; ``workspace``
    puts A in a device-memory workspace even where it fits."""
    B, m, n = A.shape
    path = path or lib.qr_r_path(m, n)
    ws = None
    if path == 1 and (workspace or lib.qr_r_workspace_doubles(m, n)):
        ws = torch.empty(B * (m | 1) * n, dtype=torch.float64)
    R = torch.empty((B, n, n), dtype=torch.float64)
    _call(lib.qr_r_launch, A, R, ws, B, m, n, path)
    return R


def emu_sne_solve(lib, R, b, tiny=1e-7):
    B, n = b.shape
    y = torch.empty((B, n), dtype=torch.float64)
    _call(lib.sne_solve_launch, R, b, y, B, n, tiny)
    return y


def _dead_column_input(B, m, n, seed=0):
    """A seeded (B, m, n) float64 A with two zero columns, one of them
    the first (a dead pivot before any reflector)."""
    A = np.random.default_rng(seed).standard_normal((B, m, n))
    A[:, :, 0] = 0.0
    A[:, :, n - 3] = 0.0
    return torch.from_numpy(A)


def _scaled(x, ref):
    return float(((x - ref).abs().flatten(1).amax(dim=1)
                  / ref.abs().flatten(1).amax(dim=1)).max())


@pytest.mark.parametrize("B,m,n,path,threads", [
    (2, 48, 29, 1, 256),      # shared memory, 256 threads (n < 48)
    (1, 72, 49, 1, 512),      # shared memory, 512 threads
    (2, 108, 37, 1, 256),     # shared memory at the (12, 24) Neumann class
    (1, 72, 49, 2, 512),      # the register tile: 16 warps, 5 x 5 slots
    (1, 132, 73, 2, 512),     # the same at the (24, 36) interior class
])
def test_qr_r_kernel_matches_plain_version(lib, B, m, n, path, threads):
    """Each body of the kernel on an A with two dead columns against
    qr_r_reference, which factors Ar = [A; diag(dead)]: R entry by entry
    (the same signs), |diag R|, the backward error against Ar's Gram
    within 10x the plain version's; a dead column's row is exactly
    -e_j."""
    A = _dead_column_input(B, m, n)
    R = emu_qr_r(lib, A, path)
    Rp = qr.qr_r_reference(A)
    Ar = qr.with_dead_rows(A)
    assert _scaled(R, Rp) < R_TOL
    assert _scaled(R.diagonal(dim1=1, dim2=2).abs(),
                   Rp.diagonal(dim1=1, dim2=2).abs()) < R_TOL
    assert not torch.tril(R, -1).any()
    assert (qr.gram_backward_error(R, Ar)
            <= QR_RATIO * qr.gram_backward_error(Rp, Ar))
    for j in (0, n - 3):
        assert torch.equal(R[:, j], -torch.eye(n, dtype=R.dtype)[j].expand(
            B, n))
        assert not R[:, :j, j].any()
    # the body's block, as qr_r_occupancy reports it
    out = [ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int(),
           ctypes.c_int(), ctypes.c_longlong()]
    assert lib.qr_r_occupancy(m, n, path,
                              *[ctypes.byref(x) for x in out]) == 0
    assert out[1].value == threads


def test_qr_r_workspace_path(lib):
    """One node with A in the device-memory workspace (the path of a
    class past shared memory) gives the shared-memory body's R exactly."""
    A = _dead_column_input(1, 48, 29, seed=1)
    torch.testing.assert_close(emu_qr_r(lib, A, 1, workspace=True),
                               emu_qr_r(lib, A, 1), rtol=0, atol=0)


def test_qr_r_path_and_workspace_per_class(lib):
    """The (24, 36) interior tet class (132 x 73) takes the register
    tile, the (12, 24) Neumann class (108 x 37) the shared-memory body,
    where each was measured faster, both with no workspace; a (64, 96)
    Neumann class (448 x 193) takes the shared-memory body from its
    workspace."""
    assert lib.qr_r_path(132, 73) == 2 and lib.qr_r_path(108, 37) == 1
    assert lib.qr_r_workspace_doubles(132, 73) == 0
    assert lib.qr_r_workspace_doubles(108, 37) == 0
    assert lib.qr_r_path(448, 193) == 1
    assert lib.qr_r_workspace_doubles(448, 193) == 449 * 193


def _occupancy(query, *args):
    out = [ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int(),
           ctypes.c_int(), ctypes.c_longlong()]
    assert query(*args, *[ctypes.byref(x) for x in out]) == 0
    return [x.value for x in out]


@pytest.mark.parametrize("rhs", ["e_n", "random"])
@pytest.mark.parametrize("n", [37, 73])
def test_sne_solve_kernel_matches_plain_version(lib, n, rhs):
    """sne_solve at the widths of the tet classes (12, 24) and (24, 36),
    on e_n and on a seeded random b, each body against
    sne_solve_reference: residual within 10x the plain version's, y to
    1e-12 of max|y| (R is well conditioned).  B = 3 on the default body
    (2), a warp a node and two a block, leaves a ragged last block.  R's
    lower triangle holds junk, which neither body may read."""
    B = 3
    R = qr.qr_r_reference(_dead_column_input(B, n + 20, n, seed=n))
    b = torch.zeros((B, n), dtype=torch.float64)
    if rhs == "e_n":
        b[:, n - 1] = 1.0
    else:
        b = torch.from_numpy(np.random.default_rng(n).standard_normal((B, n)))
    yp = qr.sne_solve_reference(R, b)
    Rj = R + torch.tril(torch.full_like(R, 3.0), -1)
    assert lib.sne_solve_path(n) == 2
    smem, threads, _, _, _ = _occupancy(lib.sne_solve_occupancy, n, 0)
    assert threads == 64 and smem == 2 * 8 * n * (n + 1) // 2
    for path in (1, 2):
        y = torch.empty((B, n), dtype=torch.float64)
        _call(lib.sne_solve_path_launch, Rj, b, y, B, n, 1e-7, path)
        assert (qr.sne_residual(R, y, b)
                <= QR_RATIO * qr.sne_residual(R, yp, b))
        assert _scaled(y, yp) < 1e-12


def test_sne_solve_kernel_on_a_clamped_pivot(lib):
    """sne_solve on an R with one pivot under tiny = 1e-7, which both
    versions take as exactly 1: residual within 10x the plain version's,
    and the solution of R with that pivot set to 1."""
    A = _dead_column_input(2, 48, 29, seed=2)
    R = qr.qr_r_reference(A)
    R[1, 5, 5] = 1e-9
    b = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 29)))
    y, yp = emu_sne_solve(lib, R, b), qr.sne_solve_reference(R, b)
    assert qr.sne_residual(R, y, b) <= QR_RATIO * qr.sne_residual(R, yp, b)
    R1 = R.clone()
    R1[1, 5, 5] = 1.0
    assert _scaled(y, qr.sne_solve_reference(R1, b)) < 1e-12


def test_plain_qr_r_with_dead_columns_matches_pallas_kernel(monkeypatch):
    """qr_r_reference(A) against ninpol_tpu's qr_r_df32 (interpret mode)
    fed Ar as its solver="pallas" route builds it (gls.py:674-686): the
    identity rows of the dead columns appended, rows padded to a multiple
    of 32.  The same R entry by entry, at the df32 kernel's 1e-12."""
    monkeypatch.setattr(pallas_qr, "INTERPRET", True)
    B, m, n = pallas_qr.NT, 40, 21
    A = _dead_column_input(B, m, n, seed=4).numpy()
    Ah = A.astype(np.float32)
    Al = (A - Ah).astype(np.float32)
    dead = np.einsum("bmn,bmn->bn", Ah, Ah) == 0
    reg = np.eye(n, dtype=np.float32)[None] * dead[:, None, :]
    pad = -(m + n) % pallas_qr.MB
    Arh = np.concatenate([Ah, reg, np.zeros((B, pad, n), np.float32)], 1)
    Arl = np.concatenate([Al, np.zeros((B, n + pad, n), np.float32)], 1)
    Rh, Rl = pallas_qr.qr_r_df32(jnp.asarray(Arh), jnp.asarray(Arl))
    Rref = np.triu(np.transpose(np.asarray(Rh, np.float64)
                                + np.asarray(Rl), (2, 0, 1))[:, :n])
    R = qr.qr_r_reference(torch.from_numpy(Ah.astype(np.float64) + Al))
    assert _scaled(R, torch.from_numpy(Rref)) < R_TOL
