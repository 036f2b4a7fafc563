"""Stencil classes too wide for a block's shared memory on the unfused
(shard_geometry=True) and CSNE (solver="pallas") routes of the PyTorch
port: each kernel of csrc/cholqr.cu and csrc/qr.cu runs the same code on
a per-node device workspace, here through the CPU emulator of
tests/utils/cuda_emu; and the GLS setting ``precond_rounds`` on each
route.  Needs g++ (C++20) for the emulated kernels."""
import ctypes

import numpy as np
import pytest
import torch

import ninpol_tpu_torch
from chip_smoke import pad_class
from ninpol_tpu.utils import meshgen
from ninpol_tpu_torch._methods.gls import gls_solve_csne
from ninpol_tpu_torch.ops import cholqr as cq
from ninpol_tpu_torch.ops import qr
from ninpol_tpu_torch.ops.gls_solve import cholqr2_solve
from tests.test_torch_cholqr import _port_chunk
from tests.test_torch_qr_emulation import emu_qr_r, emu_sne_solve
from tests.utils import cuda_emu
from tests.utils.cases import ALHCase

TOL = 1e-10          # scaled by max |w|: the reference's parity bar
RNORM_TOL = 1e-11    # the exact-fallback threshold
CPU = torch.device("cpu")
KERNELS = ("gram_f32", "round2_gram_f32", "chol_linv_f32", "prec_apply_f32")


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    if cuda_emu.gxx() is None:
        pytest.skip("needs g++ to build the emulated kernels")
    out = str(tmp_path_factory.mktemp("cuda_emu"))
    return {"cholqr": cuda_emu.build("cholqr", out, cq._bind),
            "qr": cuda_emu.build("qr", out, qr._bind)}


def _call(fn, *args):
    assert fn(*[x.data_ptr() if isinstance(x, torch.Tensor) else x
                for x in args], None) == 0


def cholqr_pieces(lib):
    """The four emulated kernels as ops/cholqr.py's wrappers launch them
    (a workspace where the node does not fit in shared memory), in the
    order cholqr2_solve takes them."""
    def out(*shape):
        return torch.empty(shape, dtype=torch.float32)

    def ws(name, B, n):
        return cq._workspace(lib, name, B, n, CPU)

    def gram(A):
        B, m, n = A.shape
        G = out(B, n, n)
        _call(lib.gram_f32_launch, A, G, ws("gram_f32", B, n), B, m, n)
        return G

    def chol_linv(G, tiny=1e-12, mul_right=None):
        B, n, _ = G.shape
        X = out(B, n, n)
        _call(lib.chol_linv_f32_launch, G, mul_right, X,
              ws("chol_linv_f32", B, n), B, n, tiny)
        return X

    def round2(A, Li):
        B, m, n = A.shape
        G = out(B, n, n)
        _call(lib.round2_gram_f32_launch, A, Li, G,
              ws("round2_gram_f32", B, n), B, m, n)
        return G

    def prec_apply(Lc, v):
        B, n = v.shape
        o = out(B, n)
        _call(lib.prec_apply_f32_launch, Lc, v, o, ws("prec_apply_f32", B, n),
              B, n)
        return o
    return gram, chol_linv, round2, prec_apply


def test_workspace_floats_per_class(emu):
    """The tet classes (24, 36) (n = 73) fit every kernel in shared
    memory; at (64, 96) (n = 193, 448 rows with Neumann faces) round2_gram,
    chol_linv and qr_r take a workspace, gram and prec_apply still fit
    (they stage one n x n matrix), and do not from n = 229 and 241."""
    lib = emu["cholqr"]
    sizes = {n: [getattr(lib, f"{k}_workspace_floats")(n) for k in KERNELS]
             for n in (73, 193, 229, 241)}
    assert sizes[73] == [0, 0, 0, 0]
    assert sizes[193][0] == 0 and sizes[193][3] == 0
    assert sizes[193][1] > 0 and sizes[193][2] > 0
    assert sizes[229][0] > 0 and sizes[241][3] > 0
    assert emu["qr"].qr_r_workspace_doubles(132, 73) == 0
    assert emu["qr"].qr_r_workspace_doubles(448, 193) > 0


@pytest.mark.parametrize("kernel,n", [
    ("gram_f32", 229), ("round2_gram_f32", 193), ("chol_linv_f32", 193),
    ("chol_linv_f32_mul_right", 193), ("prec_apply_f32", 241)])
def test_cholqr_kernel_on_its_workspace(emu, kernel, n):
    """One node of each unfused kernel at the smallest of the widths
    above that does not fit in shared memory, from its workspace, against
    the plain version: products to 1e-5 of the operands' magnitude
    product, inverse factors to 1e-4 of the factor (float32 sums in
    another order)."""
    name = kernel.replace("_mul_right", "")
    assert getattr(emu["cholqr"], f"{name}_workspace_floats")(n) > 0
    gram, chol_linv, round2, prec_apply = cholqr_pieces(emu["cholqr"])
    rng = np.random.default_rng(n)
    A = torch.as_tensor(rng.standard_normal((1, n + 40, n)),
                        dtype=torch.float32)
    A /= torch.linalg.vector_norm(A, dim=1, keepdim=True)
    G = cq.gram_f32_reference(A) + 1.5e-5 * torch.eye(n)
    Li = cq.chol_linv_f32_reference(G)

    def scaled(got, ref, mag):
        return float((got - ref).abs().max() / mag.abs().max())
    if name == "gram_f32":
        assert scaled(gram(A), cq.gram_f32_reference(A),
                      A.abs().transpose(1, 2) @ A.abs()) < 1e-5
    elif name == "round2_gram_f32":
        aQ = A.abs() @ Li.abs().transpose(1, 2)
        assert scaled(round2(A, Li), cq.round2_gram_f32_reference(A, Li),
                      aQ.transpose(1, 2) @ aQ) < 1e-5
    elif kernel == "chol_linv_f32":
        assert scaled(chol_linv(G), Li, Li) < 1e-4
    elif name == "chol_linv_f32":
        G2 = cq.round2_gram_f32_reference(A, Li)
        Lc = cq.chol_linv_f32_reference(G2, mul_right=Li)
        assert scaled(chol_linv(G2, mul_right=Li), Lc, Lc) < 1e-4
    else:
        v = torch.as_tensor(rng.standard_normal((1, n)), dtype=torch.float32)
        mag = torch.einsum("bij,bi->bj", Li.abs(),
                           torch.einsum("bij,bj->bi", Li.abs(), v.abs()))
        assert scaled(prec_apply(Li, v), cq.prec_apply_f32_reference(Li, v),
                      mag) < 1e-5


@pytest.mark.parametrize("n", [37, 73, 97])
def test_chol_linv_body_per_width(emu, n):
    """chol_linv_f32 keeps G and L^-1 P in registers up to n = 80 (the
    tet classes' 37 and 73; no dynamic shared memory) and in shared
    memory past it (97): both against the plain version, with and
    without mul_right."""
    lib = emu["cholqr"]
    out = [ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int(),
           ctypes.c_int(), ctypes.c_longlong()]
    assert lib.cholqr_occupancy(2, n, *[ctypes.byref(x) for x in out]) == 0
    assert (out[0].value == 0) == (n <= 80) and out[1].value == 256
    _, chol_linv, _, _ = cholqr_pieces(lib)
    rng = np.random.default_rng(n)
    A = torch.as_tensor(rng.standard_normal((1, n + 40, n)),
                        dtype=torch.float32)
    A /= torch.linalg.vector_norm(A, dim=1, keepdim=True)
    G = cq.gram_f32_reference(A) + 1.5e-5 * torch.eye(n)
    Li = cq.chol_linv_f32_reference(G)
    G2 = cq.round2_gram_f32_reference(A, Li)
    Lc = cq.chol_linv_f32_reference(G2, mul_right=Li)
    for X, ref in ((chol_linv(G), Li), (chol_linv(G2, mul_right=Li), Lc)):
        assert float((X - ref).abs().max() / ref.abs().max()) < 1e-4
        assert not torch.triu(X, 1).any()


@pytest.mark.parametrize("n", [37, 73, 77])
def test_round2_gram_body_per_width(emu, n):
    """round2_gram_f32 keeps the Gram in registers up to n = 76 (the tet
    classes' 37 and 73: one thread per upper 4 x 4 tile, so 64 and 192
    threads) and stages it in shared memory past it (77: 256 threads);
    against the plain version to 1e-5 of the operands' magnitude
    product."""
    lib = emu["cholqr"]
    out = [ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int(),
           ctypes.c_int(), ctypes.c_longlong()]
    assert lib.round2_gram_f32_occupancy(n, 0,
                                         *[ctypes.byref(x) for x in out]) == 0
    path = lib.round2_gram_f32_path(n)
    assert path == (2 if n <= 76 else 1)
    assert out[1].value == {37: 64, 73: 192, 77: 256}[n]
    _, _, round2, _ = cholqr_pieces(lib)
    rng = np.random.default_rng(n)
    A = torch.as_tensor(rng.standard_normal((2, n + 40, n)),
                        dtype=torch.float32)
    A /= torch.linalg.vector_norm(A, dim=1, keepdim=True)
    Li = cq.chol_linv_f32_reference(cq.gram_f32_reference(A)
                                    + 1.5e-5 * torch.eye(n))
    aQ = A.abs() @ Li.abs().transpose(1, 2)
    err = (round2(A, Li) - cq.round2_gram_f32_reference(A, Li)).abs().max()
    assert float(err / (aQ.transpose(1, 2) @ aQ).abs().max()) < 1e-5


def _occupancy(fn, n, path):
    out = [ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int(),
           ctypes.c_int(), ctypes.c_longlong()]
    assert fn(n, path, *[ctypes.byref(x) for x in out]) == 0
    return dict(zip(("smem_bytes", "threads", "blocks_per_sm"),
                    (x.value for x in out[:3])))


@pytest.mark.parametrize("n", [37, 73, 77])
def test_gram_body_per_width(emu, n):
    """gram_f32 keeps the Gram in registers up to n = 76 (the tet
    classes' 37 and 73: one thread per upper 4 x 4 tile, so 64 and 192
    threads; A in two buffers of 32 rows, or the Gram's symmetric tile)
    and accumulates it in shared memory past it (77: 256 threads); the
    register body gives the shared body's G bit for bit, and both the
    plain version's to 1e-5 of the operands' magnitude product."""
    lib = emu["cholqr"]
    occ = _occupancy(lib.gram_f32_occupancy, n, 0)
    path = lib.gram_f32_path(n)
    assert path == (2 if n <= 76 else 1)
    np_ = (n + 3) // 4 * 4
    assert occ["threads"] == {37: 64, 73: 192, 77: 256}[n]
    assert occ["smem_bytes"] == 4 * (max(2 * 32 * np_, np_ * np_)
                                     if path == 2 else np_ * np_ + 32 * np_)
    B, m = 2, n + 40
    rng = np.random.default_rng(n)
    A = torch.as_tensor(rng.standard_normal((B, m, n)), dtype=torch.float32)
    G = {}
    for p in (1, 2):
        G[p] = torch.empty((B, n, n), dtype=torch.float32)
        err = lib.gram_f32_path_launch(A.data_ptr(), G[p].data_ptr(), None,
                                       B, m, n, p, None)
        assert (err == 0) == (p == 1 or n <= 76)
    ref = cq.gram_f32_reference(A)
    mag = (A.abs().transpose(1, 2) @ A.abs()).abs().max()
    assert float((G[1] - ref).abs().max() / mag) < 1e-5
    if path == 2:
        assert torch.equal(G[1], G[2])


@pytest.mark.parametrize("n", [37, 73, 129])
def test_prec_apply_body_per_width(emu, n):
    """prec_apply_f32 runs a warp a node, four a block, on Lc's packed
    triangle and v up to n = 128 (the tet classes' 37 and 73) and a
    block of 128 threads a node past it (129): the warp body's shared
    memory is four nodes' triangles and v, the block body's one node's
    n x n and two vectors, each rounded to 4 floats; both
    bodies against the plain version to 1e-5 of the magnitude product
    (B = 5: the warp body's second block is ragged)."""
    lib = emu["cholqr"]
    occ = _occupancy(lib.prec_apply_f32_occupancy, n, 0)
    path = lib.prec_apply_f32_path(n)
    assert path == (2 if n <= 128 else 1)
    tiles = (n * (n + 1) // 2 + n if path == 2 else n * n + 2 * n) + 3
    assert occ["threads"] == 128
    assert occ["smem_bytes"] == 4 * (4 if path == 2 else 1) * (tiles // 4 * 4)
    B = 5
    rng = np.random.default_rng(n)
    Lc = torch.tril(torch.as_tensor(rng.standard_normal((B, n, n)),
                                    dtype=torch.float32))
    v = torch.as_tensor(rng.standard_normal((B, n)), dtype=torch.float32)
    ref = cq.prec_apply_f32_reference(Lc, v)
    mag = torch.einsum("bij,bi->bj", Lc.abs(),
                       torch.einsum("bij,bj->bi", Lc.abs(), v.abs()))
    for p in (1, 2):
        o = torch.empty((B, n), dtype=torch.float32)
        err = lib.prec_apply_f32_path_launch(Lc.data_ptr(), v.data_ptr(),
                                             o.data_ptr(), None, B, n, p,
                                             None)
        assert (err == 0) == (p == 1 or n <= 128)
        if err == 0:
            assert float((o - ref).abs().max() / mag.abs().max()) < 1e-5


@pytest.mark.parametrize("kernel,n", [("gram_f32", 229),
                                      ("prec_apply_f32", 241)])
def test_workspace_takes_the_shared_body(emu, kernel, n):
    """A node past shared memory runs the shared body on its workspace:
    the default body with a workspace is body 1, and the register or
    warp body, which has no workspace instance, refuses one (and refuses
    a width past its limit)."""
    lib = emu["cholqr"]
    floats = getattr(lib, f"{kernel}_workspace_floats")(n)
    assert floats > 0 and getattr(lib, f"{kernel}_path")(n) == 1
    ws = torch.empty(floats, dtype=torch.float32)
    fn = getattr(lib, f"{kernel}_path_launch")
    if kernel == "gram_f32":
        A, out = torch.zeros((1, n + 1, n)), torch.empty((1, n, n))
        args = [A.data_ptr(), out.data_ptr(), ws.data_ptr(), 1, n + 1, n]
        ref = torch.zeros((1, n, n))
    else:
        Lc, v = torch.eye(n)[None], torch.ones((1, n))
        out = torch.empty((1, n))
        args = [Lc.data_ptr(), v.data_ptr(), out.data_ptr(), ws.data_ptr(),
                1, n]
        ref = torch.ones((1, n))
    assert fn(*args, 2, None) != 0
    assert fn(*args, 0, None) == 0
    assert torch.equal(out, ref)


@pytest.mark.parametrize("n", [193, 241])
def test_sne_solve_in_a_wide_class(emu, n):
    """sne_solve stages a node's triangle in shared memory up to n = 240
    (at n = 193, 150 KB: one warp a block) and past it (241) reads R from
    device memory, one block a node: each against sne_solve_reference,
    residual within 10x the plain version's, on a random b (one node:
    the emulated 2n steps are slow under load)."""
    lib = emu["qr"]
    assert lib.sne_solve_path(n) == (2 if n <= 240 else 1)
    B = 1
    rng = np.random.default_rng(n)
    A = torch.from_numpy(rng.standard_normal((B, n + 8, n)))
    R = qr.qr_r_reference(A)
    b = torch.from_numpy(rng.standard_normal((B, n)))
    y, yp = emu_sne_solve(lib, R, b), qr.sne_solve_reference(R, b)
    assert qr.sne_residual(R, y, b) <= 10 * qr.sne_residual(R, yp, b)


@pytest.mark.parametrize("route", ["shard_geometry", "pallas"])
def test_route_gives_the_same_weights_in_a_wide_class(emu, route):
    """One node of the Neumann class of a tetra_mesh(3), padded to
    (E, F) = (64, 96) with chip_smoke.py's pad_class (phase 4e on the
    card), through the route's emulated kernels: the unpadded weights to
    1e-10 scaled, zeros on the padding cells, the same rnorm > 1e-11 set.
    On the CSNE route the padded A is 448 x 193 with 156 dead columns,
    which qr_r factors from its workspace: its R against qr_r_reference,
    entry by entry to 1e-12 of max|R|, backward error against Ar's Gram
    within 10x the plain version's."""
    inp = {k: None if v is None else v[:1].contiguous()
           for k, v in _port_chunk(neumann=True).items()}
    factored = []
    if route == "pallas":
        lib = emu["qr"]

        def qr_r_kernel(A):
            factored.append((A, emu_qr_r(lib, A)))
            return factored[-1][1]
        pieces = (qr_r_kernel, lambda R, b: emu_sne_solve(lib, R, b))

        def solve(x):
            return gls_solve_csne(**x, pieces=pieces)
    else:
        pieces = cholqr_pieces(emu["cholqr"])

        def solve(x):
            return cholqr2_solve(pieces, **x)
    w, wn, rn = solve(inp)
    w2, wn2, rn2 = solve(pad_class(inp, 64, 96))
    E = inp["dk"].shape[1]
    scale = max(w.abs().max().item(), 1.0)
    assert (w2[:, :E] - w).abs().max().item() / scale < TOL
    assert (wn2 - wn).abs().max().item() / scale < TOL
    assert not w2[:, E:].any()
    assert torch.equal(rn > RNORM_TOL, rn2 > RNORM_TOL)
    assert (rn <= RNORM_TOL).all()
    if route == "pallas":
        A, R = factored[-1]
        assert A.shape[1:] == (448, 193) and emu["qr"].qr_r_path(448, 193) == 1
        assert emu["qr"].qr_r_workspace_doubles(448, 193) > 0
        assert qr.dead_columns(A).sum(dim=1).min() >= 156
        Rp = qr.qr_r_reference(A)
        assert float((R - Rp).abs().max() / Rp.abs().max()) < 1e-12
        Ar = qr.with_dead_rows(A)
        assert (qr.gram_backward_error(R, Ar)
                <= 10 * qr.gram_backward_error(Rp, Ar))


@pytest.fixture(scope="module")
def hexa_case():
    case = ALHCase()
    case.assign_mesh_properties(meshgen.hexa_mesh(2), seed=0)
    return case


@pytest.mark.parametrize("route", ["fused", "shard_geometry", "pallas"])
def test_precond_rounds_one_changes_only_the_fused_route(hexa_case, route):
    """ninpol_tpu's GLS setting precond_rounds = 1 runs the fused route's
    single-round preconditioner (a different rounding of the same
    weights); the unfused and CSNE routes ignore it, as ninpol_tpu's do,
    and give the same weights bit for bit.  It is part of the
    prepared-weights cache key, so a cached result is not served for it."""
    port = ninpol_tpu_torch.Interpolator(device="cpu")
    port.load_mesh(mesh_obj=hexa_case.mesh)
    port.gls.fused = route != "shard_geometry"   # the unfused route
    if route == "pallas":
        port.gls.solver = "pallas"
    assert port.gls.precond_rounds == 2
    M2, _ = port.interpolate(hexa_case.name, "gls")
    keys = set(port._prep_cache)
    port.gls.precond_rounds = 1
    M1, _ = port.interpolate(hexa_case.name, "gls")
    assert set(port._prep_cache) - keys
    np.testing.assert_array_equal(M1.indices, M2.indices)
    if route == "fused":
        assert not np.array_equal(M1.data, M2.data)
        assert np.abs(M1.data - M2.data).max() < TOL
    else:
        np.testing.assert_array_equal(M1.data, M2.data)
