"""The port's CUDA kernels (ninpol_tpu_torch/csrc/cholqr.cu, gls_solve.cu)
run on the CPU through the emulator of tests/utils/cuda_emu, against
their plain PyTorch versions.  On a card
chip_smoke.py holds the compiled kernels to the same versions; here the
kernels' own index arithmetic, buffer reuse and barriers are checked
without nvcc.  Needs g++ (C++20)."""
import ctypes

import numpy as np
import pytest
import torch

from chip_smoke import pad_class
from ninpol_tpu_torch.ops import cholqr as cq
from ninpol_tpu_torch.ops import gls_solve as gs
from tests.test_torch_gls_solve import RNORM_TOL, TOL, _port_chunk
from tests.utils import cuda_emu

TOL_F32 = 1e-5    # float32 products: of the operands' magnitude product


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    if cuda_emu.gxx() is None:
        pytest.skip("needs g++ to build the emulated kernels")
    out = str(tmp_path_factory.mktemp("cuda_emu"))
    return {"cholqr": cuda_emu.build("cholqr", out, cq._bind),
            "gls_solve": cuda_emu.build("gls_solve", out, gs._bind)}


def _ptr(x):
    return None if x is None else x.data_ptr()


def _call(fn, *args):
    assert fn(*[_ptr(a) if isinstance(a, torch.Tensor) else a
                for a in args], None) == 0


def _scaled(got, ref, scale):
    return float((got - ref).abs().max() / scale.abs().max())


@pytest.mark.parametrize("kernel,m,n", [
    pytest.param(k, 48, 29, id=k)
    for k in ("gram_f32", "chol_linv_f32", "chol_linv_f32_mul_right",
              "round2_gram_f32", "prec_apply_f32")] + [
    # round2_gram_f32 at the tet classes' (m, n): (12, 24) and (24, 36)
    pytest.param("round2_gram_f32", 108, 37, id="round2_gram_f32-108x37"),
    pytest.param("round2_gram_f32", 132, 73, id="round2_gram_f32-132x73")])
def test_cholqr_kernel_matches_plain_version(emu, kernel, m, n):
    """Each unfused preconditioner kernel on a random, well-conditioned
    chunk (n = 29: a row stride padded to 32; round2_gram_f32 also at the
    route's classes), against its plain version: the products to TOL_F32
    of the operands' magnitude product, the inverse factors to 1e-4 of
    the factor.  round2_gram_f32's default body (registers, to n = 76)
    gives the shared-memory body's G bit for bit: both sum in one order."""
    lib = emu["cholqr"]
    B = 3
    rng = np.random.default_rng(0)
    A = torch.as_tensor(rng.standard_normal((B, m, n)), dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((B, n)), dtype=torch.float32)
    G = cq.gram_f32_reference(A)
    Li = cq.chol_linv_f32_reference(G)
    G2 = cq.round2_gram_f32_reference(A, Li)
    Lc = cq.chol_linv_f32_reference(G2, mul_right=Li)
    out = torch.empty((B, n, n), dtype=torch.float32)
    if kernel == "gram_f32":
        _call(lib.gram_f32_launch, A, out, None, B, m, n)
        assert _scaled(out, G, A.abs().transpose(1, 2) @ A.abs()) < TOL_F32
    elif kernel == "chol_linv_f32":
        _call(lib.chol_linv_f32_launch, G, None, out, None, B, n, 1e-12)
        assert _scaled(out, Li, Li) < 1e-4
    elif kernel == "chol_linv_f32_mul_right":
        _call(lib.chol_linv_f32_launch, G2, Li, out, None, B, n, 1e-12)
        assert _scaled(out, Lc, Lc) < 1e-4
    elif kernel == "round2_gram_f32":
        _call(lib.round2_gram_f32_launch, A, Li, out, None, B, m, n)
        aQ = A.abs() @ Li.abs().transpose(1, 2)
        assert _scaled(out, G2, aQ.transpose(1, 2) @ aQ) < TOL_F32
        assert lib.round2_gram_f32_path(n) == 2
        shared = torch.empty_like(out)
        _call(lib.round2_gram_f32_path_launch, A, Li, shared, None, B, m, n,
              1)
        assert torch.equal(out, shared)
    else:
        o = torch.empty((B, n), dtype=torch.float32)
        _call(lib.prec_apply_f32_launch, Lc, v, o, None, B, n)
        ref = cq.prec_apply_f32_reference(Lc, v)
        mag = torch.einsum("bij,bi->bj", Lc.abs(),
                           torch.einsum("bij,bj->bi", Lc.abs(), v.abs()))
        assert _scaled(o, ref, mag) < TOL_F32


def _solve(lib, inp, ws_floats=0):
    """The fused kernel on CPU tensors, as ops/gls_solve.py launches it."""
    B, E, _ = inp["dk"].shape
    F = inp["l1"].shape[1]
    f64 = torch.float64
    w, wn, rnorm = (torch.empty((B, E), dtype=f64), torch.empty(B, dtype=f64),
                    torch.empty(B, dtype=f64))
    ws = torch.empty(B * ws_floats, dtype=torch.float32) if ws_floats else None
    args = [inp[k] for k in ("dk", "l1", "l2", "t1m", "tt", "lb", "nm",
                             "pair", "ks", "cv", "fv", "isneu", "valid")]
    _call(lib.gls_solve_launch, *args, w, wn, rnorm, ws, ws_floats, B, E, F,
          int(inp["lb"] is not None), 3, 1e-12, 1.5e-5)
    return w, wn, rnorm


def _sick_chunk(neumann, nodes):
    """The first nodes of a tetra_mesh(3) class chunk, one of them made
    rank deficient as in test_clamped_pivot_forces_rnorm_one."""
    inp = {k: None if v is None else v[:nodes].clone()
           for k, v in _port_chunk(neumann=neumann).items()}
    sick = 1
    for key in ("dk", "l1", "l2", "t1m", "tt") + (("lb",) if neumann else ()):
        inp[key][sick, :, 1] = inp[key][sick, :, 0]
    return inp, sick


@pytest.mark.parametrize("neumann", [False, True])
def test_gls_solve_kernel_matches_plain_version(emu, neumann):
    """The fused kernel against gls_solve_reference, as phase 4 of
    chip_smoke.py holds them: weights to 1e-10 scaled on the nodes both
    call converged, the same rnorm > 1e-11 sets; the clamped node's rnorm
    is 1 in both."""
    inp, sick = _sick_chunk(neumann, 12)
    wk, wnk, rk = _solve(emu["gls_solve"], inp)
    wp, wnp, rp = gs.gls_solve_reference(**inp)
    assert rk[sick].item() == 1.0 and rp[sick].item() == 1.0
    conv = (rk <= RNORM_TOL) & (rp <= RNORM_TOL)
    assert conv.sum().item() >= 4
    scale = max(wp[conv].abs().max().item(), 1.0)
    assert (wk - wp)[conv].abs().max().item() / scale < TOL
    assert (wnk - wnp)[conv].abs().max().item() / scale < TOL
    assert torch.equal(rk > RNORM_TOL, rp > RNORM_TOL)
    inactive = ~inp["valid"]
    assert not wk[inactive].any() and not rk[inactive].any()


@pytest.mark.parametrize("neumann", [False, True])
def test_gls_solve_workspace_path(emu, neumann):
    """Nodes padded to (E, F) = (64, 96), too wide for an H100's shared
    memory, run from the device workspace (phase 4b of chip_smoke.py):
    the same weights, zeros on the padding cells."""
    lib = emu["gls_solve"]
    inp = {k: None if v is None else v[:2].contiguous()
           for k, v in _port_chunk(neumann=neumann).items()}
    ws = lib.gls_solve_workspace_floats(64, 96, int(neumann))
    assert ws > 0
    assert lib.gls_solve_workspace_floats(24, 36, int(neumann)) == 0
    w, wn, rn = _solve(lib, inp)
    w2, wn2, rn2 = _solve(lib, pad_class(inp, 64, 96), ws)
    E = inp["dk"].shape[1]
    scale = max(w.abs().max().item(), 1.0)
    assert (w2[:, :E] - w).abs().max().item() / scale < TOL
    assert (wn2 - wn).abs().max().item() / scale < TOL
    assert not w2[:, E:].any()
    assert torch.equal(rn > RNORM_TOL, rn2 > RNORM_TOL)


@pytest.mark.parametrize("E,F,neumann,smem,blocks", [
    (24, 36, 0, 95648, 2),     # the interior tet class
    (12, 24, 1, 36368, 6),     # the Neumann tet class
    (64, 96, 1, 27824, 8),     # A, X and Y in the device workspace
])
def test_gls_solve_shared_memory_per_class(emu, E, F, neumann, smem, blocks):
    """The kernel's dynamic shared memory per class and the blocks an
    H100 SM holds by shared memory and threads (228 KB, 2048 threads):
    the interior class keeps two.  Registers, which the emulator does
    not model, can lower the count: at 128 a thread the card holds two
    blocks of every class."""
    got_smem, got_blocks = ctypes.c_longlong(), ctypes.c_int()
    assert emu["gls_solve"].gls_solve_occupancy(
        E, F, neumann, ctypes.byref(got_smem), ctypes.byref(got_blocks)) == 0
    assert (got_smem.value, got_blocks.value) == (smem, blocks)
