"""Kernel 1's factorization probes (ninpol_tpu_torch/ops/factor_probes.py,
tools/factor_probes.py) on the CPU: each plain version against
ninpol_tpu's own factorization helpers (_chol_panels, _linv_rows) in an
interpret-mode pallas_call, as the TPU probes compose them, and against
float64 NumPy at the route's (m, n); each CUDA kernel through the
emulator of tests/utils/cuda_emu against its plain version (the
tensor-core instances through its exact emulations of the m8n8k4 and
m16n8k8 DMMA fragments, the named barrier and the bulk copy), also on a
clamped pivot, at n = 80 and n = 37 and at kernel 1's shared memory;
the tool's error and verdict paths; and the table of the TPU probes'
pallas_call sites against the code and the records."""
import contextlib
import ctypes
import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import ninpol_tpu  # noqa: F401  (x64 and the matmul precision)
from ninpol_tpu.ops import pallas_chol
from ninpol_tpu_torch.ops import cholqr as cq
from ninpol_tpu_torch.ops import factor_probes as fp
from ninpol_tpu_torch.tools import SITES, factor_probes as tool, site_of
from ninpol_tpu_torch.tools import kernel_stages
from tests.test_torch_gls_solve import _port_chunk
from tests.utils import cuda_emu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 factors, inverses, products and applies against another order
# of the same float32 arithmetic, or against float64, per node over the
# largest entry of the reference (the products over the same product of
# the operands' magnitudes): ~100 eps32 of room, as kernel_stages.CUT_TOL
# holds the float32 stages; these inputs have cond(G1) < 50
TOL = kernel_stages.CUT_TOL["chol1"]
NT = pallas_chol.NT
N_PAD = 16           # the interpret-mode tile: ~2 s a call at 16, ~33 s at 80
K1_REQUEST = 105824  # kernel 1's dynamic shared memory at (24, 36)
APPLIES = tool.APPLIES


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's default of one
    thread per core would oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _node_err(x, ref, scale=None):
    """max over nodes of max|x - ref| / max|scale| (scale: ref), per node."""
    x, ref = (np.asarray(a, np.float64).reshape(len(a), -1) for a in (x, ref))
    s = ref if scale is None else np.asarray(scale, np.float64).reshape(
        len(ref), -1)
    return float((np.abs(x - ref).max(1) / np.abs(s).max(1)).max())


def _route_inputs(m, n, B, seed=0):
    """Float64 inputs shaped as the unfused route makes them: equilibrated
    A, G1 = A^T A + shift, L1, Li1 = L1^-1, G2 = (A Li1^T)^T (A Li1^T),
    and a vector."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, n))
    A /= np.linalg.norm(A, axis=1, keepdims=True)
    G1 = np.einsum("bmi,bmj->bij", A, A) + 1.5e-5 * np.eye(n)
    L1 = np.linalg.cholesky(G1)
    Li1 = np.linalg.inv(L1)
    Q = np.einsum("bmj,bkj->bmk", A, Li1)
    G2 = np.einsum("bmi,bmj->bij", Q, Q)
    v = rng.standard_normal((B, n))
    return dict(A=A, G1=G1, L1=L1, Li1=Li1, G2=G2, v=v)


def _f32(x):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32)


def _t(x):
    return np.transpose(x, (0, 2, 1))


def _applies(Li1, L2, v):
    """APPLIES times v <- Li1^T L2^-T L2^-1 Li1 v in float64, by solves."""
    for _ in range(APPLIES):
        u = np.einsum("bij,bj->bi", Li1, v)[..., None]
        y = np.linalg.solve(_t(L2), np.linalg.solve(L2, u))
        v = np.einsum("bij,bi->bj", Li1, y[..., 0])
    return v


# ---------------------------------------------------------------------------
# plain versions against ninpol_tpu's helpers in interpret mode
# ---------------------------------------------------------------------------
def _jax_factor(G, form):
    """ninpol_tpu's _chol_panels and _linv_rows on one NT-node tile of
    SPD matrices G (NT, n, n), composed as the TPU probes compose them:
    the production form (tri=True) or the MXU super-panel form (lt_scr,
    limx_scr, sup=8).  Returns (L, L^-1, dinv), L's lower triangle with
    its diagonal."""
    n, f32 = G.shape[1], jnp.float32

    def sp(*dims):
        return pl.BlockSpec((1,) + dims, lambda i: (i,) + (i * 0,) * len(dims),
                            memory_space=pltpu.VMEM)

    def kern(g_ref, l_ref, li_ref, d_ref, g_scr, *mxu):
        g_scr[:] = g_ref[0]
        if form == "tri":
            dinvs = pallas_chol._chol_panels(g_scr, n, 1e-12, tri=True)
            pallas_chol._linv_rows(g_scr, li_ref.at[0], n, dinvs, tri=True)
        else:
            lt, limx = mxu
            dinvs = pallas_chol._chol_panels(g_scr, n, 1e-12, lt_scr=lt,
                                             sup=8)
            pallas_chol._linv_rows(g_scr, li_ref.at[0], n, dinvs,
                                   limx_scr=limx, sup=8)
        l_ref[0] = g_scr[:]
        d_ref[0] = jnp.stack(dinvs, axis=0)

    scratch = [pltpu.VMEM((n, n, NT), f32)]
    if form != "tri":
        scratch += [pltpu.VMEM((NT, n, n), f32)] * 2
    call = pl.pallas_call(
        kern, grid=(1,), in_specs=[sp(n, n, NT)],
        out_specs=[sp(n, n, NT), sp(n, n, NT), sp(n, NT)],
        out_shape=[jax.ShapeDtypeStruct((1, n, n, NT), f32)] * 2
        + [jax.ShapeDtypeStruct((1, n, NT), f32)],
        scratch_shapes=scratch, interpret=True)
    # column planes: gscr[c, r, node] = G[node, r, c]
    l, li, d = (np.asarray(x)[0] for x in call(
        jnp.asarray(np.transpose(G, (2, 1, 0))[None], f32)))
    # L leaves in column planes, L^-1 in row planes li[r, c, node]
    return (np.tril(np.transpose(l, (2, 1, 0))), np.transpose(li, (2, 0, 1)),
            d.T)


@pytest.fixture(scope="module", params=["tri", "sup8"])
def jax_tile(request):
    """One interpret-mode tile of each form: nodes 0 .. NT/2 - 1 hold G1
    of NT/2 route-shaped systems at n = N_PAD, the others their G2."""
    r = _route_inputs(24, N_PAD, NT // 2)
    G = np.concatenate([r["G1"], r["G2"]]).astype(np.float32)
    L, Li, dinv = _jax_factor(G, request.param)
    return r, G, L, Li, dinv


def test_chol_factor_plain_matches_chol_panels(jax_tile):
    """chol_factor's plain version gives _chol_panels' factor, and 1 /
    its diagonal the helper's dinv."""
    _, G, L, _, dinv = jax_tile
    got = fp.chol_factor_reference(_f32(G)).numpy()
    assert _node_err(got, L) < TOL
    assert _node_err(1.0 / np.diagonal(got, axis1=1, axis2=2), dinv) < TOL
    assert (np.triu(got, 1) == 0).all()


def test_chol_linv_tc_plain_matches_linv_rows(jax_tile):
    """chol_linv_tc's plain version gives _linv_rows' L^-1 (its rows are
    exactly zero right of the diagonal in both)."""
    _, G, _, Li, _ = jax_tile
    got = fp.chol_linv_tc_reference(_f32(G)).numpy()
    assert _node_err(got, Li) < TOL
    assert (np.triu(got, 1) == 0).all() and (np.triu(Li, 1) == 0).all()


def test_chol_trsm_gram_plain_matches_helper_factor(jax_tile):
    """chol_trsm_gram's plain version (forward substitution, no L^-1)
    gives the G2 of trsm_probe.py's variant A: Q = A Li1^T with the
    helpers' L1^-1, then Q^T Q (float64 here)."""
    r, _, _, Li, _ = jax_tile
    B = NT // 2
    Q = np.einsum("bmj,bkj->bmk", r["A"], Li[:B].astype(np.float64))
    want = np.einsum("bmi,bmj->bij", Q, Q)
    aQ = np.abs(r["A"]) @ np.abs(_t(Li[:B]))
    got = fp.chol_trsm_gram_reference(_f32(r["A"]), _f32(r["G1"])).numpy()
    assert _node_err(got, want, _t(aQ) @ aQ) < TOL


def test_chol_trisolve_apply_plain_matches_helper_factor(jax_tile):
    """chol_trisolve_apply's plain version (two triangular solves an
    apply) gives trisolve_probe.py's explicit form, APPLIES times
    Lc^T Lc v with Lc = L2^-1 Li1 from the helpers' L2^-1 of G2."""
    r, _, _, Li, _ = jax_tile
    B = NT // 2
    Li1 = np.tril(r["Li1"]).astype(np.float32)
    Lc = Li[B:].astype(np.float64) @ Li1
    want = r["v"]
    for _ in range(APPLIES):
        want = np.einsum("bij,bi->bj", Lc, np.einsum("bij,bj->bi", Lc, want))
    got = fp.chol_trisolve_apply_reference(
        _f32(r["G2"]), _f32(Li1), _f32(r["v"]), applies=APPLIES).numpy()
    assert _node_err(got, want) < TOL


# ---------------------------------------------------------------------------
# plain versions against float64 NumPy at the route's classes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,n", [(132, 73), (108, 37)],
                         ids=["24x36", "12x24"])
def test_plain_versions_match_float64(m, n):
    """The TPU probes' own oracle, in float64: L = chol(G1), X = solve(L,
    A^T), G2 = X X^T, L^-1, L2^-1 L1^-1, and M v through two solves with
    L2 of G2."""
    r = _route_inputs(m, n, 4)
    A, G1, G2, v = (_f32(r[k]) for k in ("A", "G1", "G2", "v"))
    Li1 = _f32(np.tril(r["Li1"]))
    assert _node_err(fp.chol_factor_reference(G1).numpy(), r["L1"]) < TOL
    assert _node_err(fp.chol_linv_tc_reference(G1).numpy(), r["Li1"]) < TOL
    Li2 = np.linalg.inv(np.linalg.cholesky(r["G2"]))
    want = Li2 @ np.tril(r["Li1"]).astype(np.float32).astype(np.float64)
    assert _node_err(fp.chol_linv_tc_reference(G2, mul_right=Li1).numpy(),
                     want) < TOL
    X = np.linalg.solve(r["L1"], _t(r["A"]))
    aQ = np.abs(r["A"]) @ np.abs(_t(r["Li1"]))
    assert _node_err(fp.chol_trsm_gram_reference(A, G1).numpy(), X @ _t(X),
                     _t(aQ) @ aQ) < TOL
    want = _applies(np.tril(r["Li1"]).astype(np.float32).astype(np.float64),
                    np.linalg.cholesky(r["G2"]), r["v"])
    got = fp.chol_trisolve_apply_reference(G2, Li1, v, applies=APPLIES)
    assert _node_err(got.numpy(), want) < TOL


def test_wrappers_run_plain_versions_on_cpu():
    """On CPU tensors each wrapper is its plain version and launches
    nothing (chol_linv_tc with a right factor chol_linv_f32's L^-1 P);
    widths outside the kernels' instances and a right factor of another
    shape raise."""
    r = _route_inputs(30, 19, 2)
    A, G1, G2, v = (_f32(r[k]) for k in ("A", "G1", "G2", "v"))
    Li1 = _f32(np.tril(r["Li1"]))
    before = [w.launches for w in fp.KERNELS]
    assert torch.equal(fp.chol_factor(G1), fp.chol_factor_reference(G1))
    assert torch.equal(fp.chol_trsm_gram(A, G1, width=16),
                       fp.chol_trsm_gram_reference(A, G1))
    assert torch.equal(fp.chol_linv_tc(G1, width=8),
                       fp.chol_linv_tc_reference(G1))
    assert torch.equal(fp.chol_linv_tc(G2, mul_right=Li1),
                       cq.chol_linv_f32_reference(G2, mul_right=Li1))
    assert torch.equal(fp.chol_trisolve_apply(G2, Li1, v, block=1),
                       fp.chol_trisolve_apply_reference(G2, Li1, v))
    assert [w.launches for w in fp.KERNELS] == before
    with pytest.raises(ValueError):
        fp.chol_trsm_gram(A, G1, width=48)
    with pytest.raises(ValueError):
        fp.chol_linv_tc(G1, width=24)
    with pytest.raises(ValueError):
        fp.chol_trisolve_apply(G2, Li1, v, block=4)
    with pytest.raises(ValueError):
        fp.chol_trsm_gram(A[:, :, :-1], G1)
    with pytest.raises(ValueError):
        fp.chol_linv_tc(G1, width=8, smem_bytes=-1)
    with pytest.raises(ValueError):
        fp.chol_linv_tc(G2, mul_right=Li1[:, :, :-1].contiguous())
    assert torch.equal(fp.chol_linv_tc(G1, width=8, smem_bytes=95648),
                       fp.chol_linv_tc_reference(G1))


# ---------------------------------------------------------------------------
# the CUDA kernels, emulated on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    if cuda_emu.gxx() is None:
        pytest.skip("needs g++ to build the emulated kernels")
    return cuda_emu.build("factor_probes",
                          str(tmp_path_factory.mktemp("cuda_emu")), fp._bind)


def _call(fn, *args):
    assert fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args], None) == 0


def _emulated(lib, kernel, kw, t, smem=0):
    """One emulated launch of ``kernel`` with the wrapper's arguments
    ``kw`` on the float32 tensors ``t`` (As, G1, Li1, G2, v), chol_trsm_gram
    and chol_linv_tc at a shared memory request of ``smem`` bytes
    (chol_linv_tc with ``mul_right`` on G2 and Li1)."""
    B, m, n = t["As"].shape
    out = torch.empty_like(t["v"] if kernel == "chol_trisolve_apply"
                           else t["G1"])
    if kernel == "chol_factor":
        _call(lib.chol_factor_launch, t["G1"], out, B, n, 1e-12)
    elif kernel == "chol_trsm_gram":
        _call(lib.chol_trsm_gram_launch, t["As"], t["G1"], out, B, m, n,
              kw["width"], 1e-12, smem)
    elif kernel == "chol_linv_tc" and kw.get("mul_right"):
        _call(lib.chol_linv_tc_launch, t["G2"], t["Li1"], out, B, n,
              kw["width"], 1e-12, smem)
    elif kernel == "chol_linv_tc":
        _call(lib.chol_linv_tc_launch, t["G1"], None, out, B, n, kw["width"],
              1e-12, smem)
    else:
        _call(lib.chol_trisolve_apply_launch, t["G2"], t["Li1"], t["v"], out,
              B, n, APPLIES, kw["block"], 1e-12)
    return out


@pytest.mark.parametrize("kernel,kw", tool.CONFIGS,
                         ids=[tool.label(k, kw) for k, kw in tool.CONFIGS])
@pytest.mark.parametrize("m,n,B", [(30, 19, 2), (132, 73, 1)],
                         ids=["30x19", "24x36"])
def test_kernel_matches_plain_version(emu, kernel, kw, m, n, B):
    """Each kernel instance (chol_trsm_gram after every factor;
    chol_linv_tc at its four widths;
    chol_trisolve_apply at both blocks) on route-shaped float32 inputs,
    against its plain version: the products over the operands' magnitude
    product, the rest over the result's own magnitude, within TOL.  n =
    19 pads to 24 for the tensor cores (panels of 16 leave a ragged one
    of 8), m = 30 to 32, and takes the register kernels' narrow instances
    (the Neumann class's, which test_tool_errors_on_route_chunks runs at
    its own shape); (132, 73) is the interior class, one node (each
    emulated barrier costs a scheduler round trip under the suite's
    workers)."""
    r = _route_inputs(m, n, B)
    t = {"As": _f32(r["A"]), "G1": _f32(r["G1"]), "G2": _f32(r["G2"]),
         "Li1": _f32(np.tril(r["Li1"])), "v": _f32(r["v"])}
    got = _emulated(emu, kernel, kw, t)
    ref = tool.run(kernel, kw, t, plain=True)
    scale = None
    if kernel == "chol_trsm_gram":
        aQ = t["As"].abs() @ t["Li1"].abs().transpose(1, 2)
        scale = aQ.transpose(1, 2) @ aQ
    assert _node_err(got, ref, scale) < TOL
    if kernel in ("chol_factor", "chol_linv_tc"):
        assert (torch.triu(got, 1) == 0).all()


_BLOCKED = [(k, kw) for k, kw in tool.CONFIGS if k in tool.K1_KERNELS]


def _clamped(r, pivots, key="G1"):
    """Route inputs with node b's row and column ``pivots[b]`` of G1 (and
    that column of A), or of ``key``, zeroed: an exact zero pivot, clamped
    at tiny, in block 0 (factored before the loop) or a later block
    (factored by the update's lookahead)."""
    for b, k in enumerate(pivots):
        if key == "G1":
            r["A"][b, :, k] = 0.0
        r[key][b, k, :] = r[key][b, :, k] = 0.0
    return r


@pytest.mark.parametrize("kernel,kw", _BLOCKED,
                         ids=[tool.label(k, kw) for k, kw in _BLOCKED])
@pytest.mark.parametrize("case", ["clamped", "n80", "n37"])
def test_blocked_kernels_edge_cases(emu, kernel, kw, case):
    """Every instance of chol_trsm_gram and chol_linv_tc against its plain
    version (emulated) on a clamped pivot (a zero row and column of G1,
    of G2 with a right factor: L^-1 takes 1/sqrt(tiny) there, so row k
    of L^-1 P is 1/sqrt(tiny) times P's, held apart, the rest within
    TOL), at n = 80 (n a multiple of 8, no padding, the most blocks the
    kernels take) and at n = 37 (the Neumann class: padded to 40, A by
    one bulk copy)."""
    m, n, B = {"clamped": (40, 21, 2), "n80": (96, 80, 1),
               "n37": (108, 37, 2)}[case]
    r = _route_inputs(m, n, B, seed=3)
    pivots = (9, 3)
    right = kw.get("mul_right", False)
    if case == "clamped":
        r = _clamped(r, pivots, "G2" if right else "G1")
    t = {"As": _f32(r["A"]), "G1": _f32(r["G1"]), "G2": _f32(r["G2"]),
         "Li1": _f32(np.tril(r["Li1"])), "v": _f32(r["v"])}
    got = _emulated(emu, kernel, kw, t)
    ref = tool.run(kernel, kw, t, plain=True)
    assert torch.isfinite(got).all()
    if kernel == "chol_trsm_gram":
        Li = fp.chol_linv_tc_reference(t["G1"])
        aQ = t["As"].abs() @ Li.abs().transpose(1, 2)
        assert _node_err(got, ref, aQ.transpose(1, 2) @ aQ) < TOL
        return
    if case == "clamped":
        for b, k in enumerate(pivots):
            p = float(t["Li1"][b, k, k]) if right else 1.0
            assert ref[b, k, k] == pytest.approx(1e6 * p, rel=1e-6)
            if right:
                row = slice(k, k + 1)
                assert _node_err(got[b, row], ref[b, row]) < TOL
                got[b, row] = ref[b, row] = 0.0
            else:
                assert got[b, k, k] == pytest.approx(float(ref[b, k, k]),
                                                     rel=TOL)
                got[b, k, k] = ref[b, k, k] = 0.0
    assert _node_err(got, ref) < TOL
    assert (torch.triu(got, 1) == 0).all()


@pytest.mark.parametrize("kernel,kw", _BLOCKED,
                         ids=[tool.label(k, kw) for k, kw in _BLOCKED])
def test_blocked_kernels_at_kernel1_shared_memory(emu, kernel, kw):
    """A shared memory request past the instance's need (kernel 1's, to
    run at its blocks an SM) changes the launch, not the result: the same
    output bit for bit (the emulator's 30 x 19 chol_trsm_gram copies A by
    elements, 132 x 73 by one bulk copy), the request in the occupancy
    query's shared memory and 2 blocks an SM there."""
    for m, n, B in ((30, 19, 2), (132, 73, 1)):
        r = _route_inputs(m, n, B)
        t = {"As": _f32(r["A"]), "G1": _f32(r["G1"]), "G2": _f32(r["G2"]),
             "Li1": _f32(np.tril(r["Li1"]))}
        assert torch.equal(_emulated(emu, kernel, kw, t),
                           _emulated(emu, kernel, kw, t, smem=K1_REQUEST))
    right = kw.get("mul_right", False)
    occ = cuda_emu_occupancy(emu, kernel, 132, 73, kw["width"], 0, right)
    k1 = cuda_emu_occupancy(emu, kernel, 132, 73, kw["width"], K1_REQUEST,
                            right)
    assert occ["smem_bytes"] < K1_REQUEST == k1["smem_bytes"]
    assert k1["blocks_per_sm"] == 2 < occ["blocks_per_sm"]


def cuda_emu_occupancy(lib, kernel, m, n, width, request, right=False):
    """The emulated library's occupancy query of an instance (``right``:
    chol_linv_tc with a right factor)."""
    from ninpol_tpu_torch.ops import cuda_lib

    return cuda_lib.occupancy(lib.factor_probes_occupancy, kernel,
                              fp._RIGHT_ID if right else fp._IDS[kernel],
                              m, n, width, request)


_NAMED_BARRIER = r"""
#include <cuda_runtime.h>
#include <chrono>

// Eight warps, ``rounds`` rounds: warp 0 sleeps, writes the round into 32
// slots of shared memory and arrives on named barrier 1 (bar.arrive);
// warps 1..7 wait on it (bar.sync) and record the slots; a block barrier
// ends the round.  A wait that did not wait reads the round before.
__global__ void named_kernel(int* out, int rounds) {
  __shared__ int slots[32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = 0; r < rounds; ++r) {
    if (warp == 0) {
      if (lane == 0) std::this_thread::sleep_for(std::chrono::milliseconds(2));
      slots[lane] = 1000 * blockIdx.x + r;
      emu_named_barrier(1, 256, false);
    } else {
      emu_named_barrier(1, 256, true);
      out[(blockIdx.x * rounds + r) * 224 + threadIdx.x - 32] = slots[(lane + warp) % 32];
    }
    __syncthreads();
  }
}

extern "C" int named_blocks(int* out, int blocks, int rounds) {
  named_kernel<<<blocks, 256, 0, nullptr>>>(out, rounds);
  return 0;
}
"""


def test_emulated_named_barrier(tmp_path):
    """bar.arrive / bar.sync as the emulator runs them (warps as OS
    threads): the waiting warps see what the arriving warp wrote before
    it arrived, in every round and block (the barrier's count starts each
    phase and block at 0)."""
    if cuda_emu.gxx() is None:
        pytest.skip("needs g++ to build the emulated kernels")

    def bind(lib):
        lib.named_blocks.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int]

    lib = cuda_emu.build_text(_NAMED_BARRIER, "named", str(tmp_path), bind)
    out = torch.full((2 * 3 * 224,), -1, dtype=torch.int32)
    lib.named_blocks(out.data_ptr(), 2, 3)
    want = torch.tensor([1000 * b + r for b in range(2) for r in range(3)],
                        dtype=torch.int32).repeat_interleave(224)
    assert torch.equal(out, want)


def test_trisolve_matches_prec_apply_chain(emu):
    """chol_trisolve_apply computes what the route applies with the
    explicit factor: APPLIES times prec_apply_f32(L2^-1 Li1, v)."""
    r = _route_inputs(132, 73, 1)
    t = {"As": _f32(r["A"]), "G1": _f32(r["G1"]), "G2": _f32(r["G2"]),
         "Li1": _f32(np.tril(r["Li1"])), "v": _f32(r["v"])}
    Lc = cq.chol_linv_f32_reference(t["G2"], mul_right=t["Li1"])
    want = t["v"]
    for _ in range(APPLIES):
        want = cq.prec_apply_f32_reference(Lc, want)
    for block in fp.TRISOLVE_BLOCKS:
        got = _emulated(emu, "chol_trisolve_apply", {"block": block}, t)
        assert _node_err(got, want) < TOL


def test_tool_errors_on_route_chunks(emu, monkeypatch):
    """The tool's inputs and error path on the route's own chunks
    (tetra_mesh(3)): the unfused route's tensors from ``prepare`` for
    both classes, then, on two nodes of the Neumann class (m, n) = (108,
    37), every kernel instance emulated and held to its plain version by
    ``probe_errors`` within its tolerance, a launch counted for each."""
    chunks = []
    for neumann in (False, True):
        inp = _port_chunk(neumann=neumann)
        c = {"E": inp["dk"].shape[1], "F": inp["l1"].shape[1],
             "with_neumann": neumann}
        chunks.append((c, inp, None))
    prepared = tool.prepare(chunks)
    assert [(h["m"], h["n"]) for h, _ in prepared] == [(132, 73), (108, 37)]
    for head, t in prepared:
        assert t["As"].shape[1:] == (head["m"], head["n"])
    head, t = prepared[1]
    prepared = [(dict(head, chunk=2, k1_request=K1_REQUEST),
                 {k: v[:2].contiguous() for k, v in t.items()})]
    monkeypatch.setattr(fp.library, "lib", emu)
    monkeypatch.setattr(fp, "on_card", lambda x, name: True)
    monkeypatch.setattr(fp, "stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    tool.reset_counts()
    errors = tool.probe_errors(prepared)
    assert all(n > 0 for n in tool.launch_counts().values())
    for errs in errors:
        assert set(errs) == {tool.label(k, w) for k, w in tool.CONFIGS}
        for name, e in errs.items():
            assert e["max_err"] <= e["tol"], (name, e)
            assert e["nodes"] == 2 and e["tol"] >= TOL
            if name.split("[")[0] in tool.K1_KERNELS:
                assert e["max_err_k1"] <= e["tol"], (name, e)


def test_verdicts_follow_the_tpu_rules():
    """The four verdicts on made-up times: trsm's B and C (its fastest
    width) against A standalone and A's stages, trisolve_probe.py:173's
    rule, each chol_linv_tc width against chol_linv_f32 and the chol1
    cut, and chol_linv_tc with a right factor, at kernel 1's shared
    memory, against chol_linv_f32 with P and the chol2 cut."""
    assert len(tool.CONFIGS) == 12
    k = {tool.label(kn, kw): {"ms": ms} for (kn, kw), ms in zip(
        tool.CONFIGS, (2.0, 9.5, 9.0, 7.5, 9.2, 6.0, 5.0, 4.0, 5.5,
                       1.5, 9.0, 4.5))}
    k["chol_factor"]["ms_on_g2"] = 2.5
    k["chol_linv_tc[width=16,mul_right=True]"]["ms_k1"] = 2.4
    row = {"kernels": k,
           "standalone": {"chol_linv_f32": 4.8, "chol_linv_f32_p": 4.8,
                          "round2_gram_f32": 3.1, "prec_apply_f32": 0.2},
           "stages": {"chol1": 8.4, "chol2": 9.6, "chol1_to_gram2": 13.0}}
    v = tool.verdicts(row)
    assert not v["trsm"]["B_beats_A_standalone"]          # 9.5
    assert v["trsm"]["B_beats_A_stages"]                  # 9.5 < 13.0
    assert v["trsm"]["C_width"] == 16 and v["trsm"]["C_ms"] == 7.5
    assert v["trsm"]["C_beats_A_standalone"]              # 7.5 < 7.9
    # block 8: (4.5 - 2.5) < 4 x 0.2 + (4.8 - 2.5); block 1: 9.0 - 2.5 is not
    assert v["trisolve"]["blocks"]["8"]["solves_win"]
    assert not v["trisolve"]["blocks"]["1"]["solves_win"]
    assert v["trisolve"]["explicit_ms"] == pytest.approx(3.1)
    assert v["chol_mxu"]["32"]["over_chol_linv_f32"] == pytest.approx(4 / 4.8)
    assert v["chol2"]["ms"] == 1.5 and v["chol2"]["ms_k1"] == 2.4
    assert v["chol2"]["over_chol_linv_f32_p"] == pytest.approx(0.5)
    assert v["chol2"]["over_chol2_cut"] == pytest.approx(0.25)
    assert tool.failed([{"E": 24, "F": 36, "kernels": {
        "chol_factor": {"max_err": 2e-5, "tol": 1e-5}}}])


def test_k1_checks_flag_errors_and_missing_launches():
    """The checks at kernel 1's shared memory: ``failed`` flags an error
    past tolerance there alone, ``unlaunched_k1`` an instance of
    K1_KERNELS with no launch there (and no other kernel)."""
    def row(err_k1, launches_k1):
        return {"E": 24, "F": 36, "kernels": {
            "chol_linv_tc[width=8]": {"kernel": "chol_linv_tc",
                                      "max_err": 1e-6, "tol": 1e-5,
                                      "max_err_k1": err_k1,
                                      "launches_k1": launches_k1},
            "chol_factor": {"kernel": "chol_factor", "max_err": 1e-6,
                            "tol": 1e-5}}}

    assert tool.failed([row(2e-6, 6)]) == []
    bad = tool.failed([row(2e-5, 6)])
    assert len(bad) == 1 and "kernel 1's shared memory" in bad[0]
    assert tool.unlaunched_k1([row(2e-6, 6)]) == []
    assert tool.unlaunched_k1([row(2e-6, 0)]) == [
        "(24, 36) chol_linv_tc[width=8]: no launch at kernel 1's shared "
        "memory"]


def test_work_counts_what_the_functions_need():
    """The bounds' FLOPs and bytes at the interior class: G's and Li's
    (and P's) lower triangles read (all every kernel reads of them), A
    and v read whole, the dense outputs written whole."""
    head = {"chunk": 2, "m": 132, "n": 73}
    tri, square = 2 * 73 * 74 // 2 * 4, 2 * 73 * 73 * 4
    f, b = tool.work("chol_factor", head)
    assert f == 2 * 73 ** 3 / 3 and b == tri + square
    f, b = tool.work("chol_trsm_gram", head)
    assert f == 2 * (73 ** 3 / 3 + 132 * 73 * 73 + 132 * 73 * 74)
    assert b == 2 * 132 * 73 * 4 + tri + square
    assert tool.work("chol_linv_tc", head) == (2 * 2 * 73 ** 3 / 3,
                                               tri + square)
    assert tool.work("chol_linv_tc (mul_right)", head) == (
        2 * 2 * 73 ** 3 / 3, 2 * tri + square)
    f, b = tool.work("chol_trisolve_apply", head)
    assert f == 2 * (73 ** 3 / 3 + APPLIES * (2 * 73 * 74 + 2 * 73 * 73))
    assert b == 2 * tri + 2 * 2 * 73 * 4


def test_kernels_line_names_each_site():
    """chip_smoke.py's kernels-line entries of the probes: one a tools/
    site, chol_trsm_gram's variants B (width 0) and C (its panel widths)
    apart, chol_linv_tc with a right factor (trisolve_probe.py:95) apart
    from its L^-1 instances, each with its own instances' launches and
    its fastest instance's numbers."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    labels = [tool.label(k, kw) for k, kw in tool.CONFIGS]
    ms = dict(zip(labels, (3.2, 6.9, 6.2, 6.4, 7.2, 4.1, 4.6, 5.9, 6.7,
                           1.6, 7.2, 7.5)))

    def row(chunk, scale):
        return {"E": 24, "F": 36, "with_neumann": False, "chunk": chunk,
                "kernels": {label: {
                    "kernel": label.split("[")[0], "ms": scale * ms[label],
                    "plain_ms": 20.0, "bound_ms": 0.3, "bound_by": "bytes",
                    "library_ms": 5.0, "max_abs_err": 1e-6, "max_err": 1e-7,
                    "out_max": 2.0} for label in labels}}

    launches = {label: i + 1 for i, label in enumerate(labels)}
    entries = smoke.factor_entries([row(9579, 0.1), row(32768, 1.0)],
                                   launches)
    by_site = {e["replaces"]: e for e in entries}
    assert set(by_site) == {
        "tools/trisolve_probe.py:79", "tools/trsm_probe.py:129",
        "tools/trsm_probe.py:192", "tools/chol_mxu_probe.py:73",
        "tools/trisolve_probe.py:95",
        "tools/trisolve_probe.py:162"}
    b, c = by_site["tools/trsm_probe.py:129"], by_site[
        "tools/trsm_probe.py:192"]
    assert b["instance"] == "chol_trsm_gram[width=0]" and b["ms"] == 6.9
    assert b["launches"] == launches["chol_trsm_gram[width=0]"]
    assert c["instance"] == "chol_trsm_gram[width=8]" and c["ms"] == 6.2
    assert c["launches"] == sum(launches[f"chol_trsm_gram[width={w}]"]
                                for w in (8, 16, 32))
    assert len(c["classes"]) == 2 * 3
    d, x = by_site["tools/trisolve_probe.py:95"], by_site[
        "tools/chol_mxu_probe.py:73"]
    assert d["instance"] == "chol_linv_tc[width=16,mul_right=True]"
    assert d["ms"] == 1.6 and d["launches"] == launches[d["instance"]]
    assert x["launches"] == sum(launches[f"chol_linv_tc[width={w}]"]
                                for w in (8, 16, 32, 48))
    assert sum(e["launches"] for e in entries) == sum(launches.values())
    for e in entries:
        assert e["source"] == "ninpol_tpu_torch/csrc/factor_probes.cu"
        assert e["timed_class"]["chunk"] == 32768


# ---------------------------------------------------------------------------
# the TPU probes' sites
# ---------------------------------------------------------------------------
def _tools_sites():
    sites = set()
    for path in sorted(glob.glob(os.path.join(ROOT, "tools", "*.py"))):
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if "pl.pallas_call(" in line:
                    sites.add(f"{os.path.basename(path)}:{i}")
    return sites


def test_every_tools_site_has_a_row():
    """Every pl.pallas_call( line of the repo's tools/*.py is a row of the
    port's site table, and every row is such a line: ported (by a stage
    cut or a probe kernel) or answered by a named kernel or cut, none
    queued; each probe kernel of ops/factor_probes.py, ops/mxu_probes.py
    and ops/input_probes.py ports a site, and site_of finds it; the input
    sites of r5_layout_probe.py and r5_overlap_probe.py are ported by
    input_probes' kernels."""
    from ninpol_tpu_torch.ops import input_probes as ip
    from ninpol_tpu_torch.ops import mxu_probes as mp

    assert _tools_sites() == set(SITES)
    status = [s for s, _ in SITES.values()]
    assert len(SITES) == 34 and status.count("queued") == 0
    assert {site.split(":")[0] for site, (_, by) in SITES.items()
            if hasattr(ip, by.split(" (")[0])} == {"r5_layout_probe.py",
                                                   "r5_overlap_probe.py"}
    probes = set()
    for site, (s, by) in SITES.items():
        assert s in ("ported", "answered") and by
        name = by.split(" (")[0]
        for module in (fp, mp, ip):
            if s == "ported" and hasattr(module, name):
                assert getattr(module, name) in module.KERNELS
                assert site_of(by) == f"tools/{site}"
                probes.add(name)
    assert probes == {w.__name__
                      for w in fp.KERNELS + mp.KERNELS + ip.KERNELS}


def test_records_list_every_site():
    """PERF.md's site table gives each file's row every one of its sites
    (":line"), and calls none queued that SITES does not; ROADMAP.md
    queues every file with a queued site."""
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read().splitlines()
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        roadmap = f.read()
    by_file = {}
    for site in SITES:
        name, line = site.split(":")
        by_file.setdefault(name, []).append(line)
    for name, lines in by_file.items():
        rows = [r for r in perf if r.startswith(f"| `{name}`")]
        assert len(rows) == 1, name
        for line in lines:
            assert re.search(rf":{line}\b", rows[0]), (name, line)
        if all(SITES[f"{name}:{n}"][0] != "queued" for n in lines):
            assert "queued" not in rows[0], name
        if any(SITES[f"{name}:{n}"][0] == "queued" for n in lines):
            assert name in roadmap, name
