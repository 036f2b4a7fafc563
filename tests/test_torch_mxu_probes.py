"""Kernel 1's tensor-core Gram and Q probes (ninpol_tpu_torch/ops/
mxu_probes.py, tools/mxu_probes.py) on the CPU: each plain version against
ninpol_tpu (its _gram_mxu helper and the bodies of tools/mxu_probe.py and
r5_mxu_shapes.py, re-written in an interpret-mode pallas_call, and the
gram_f32 and round2_gram_f32 kernels through their TPU branch) and against
float64 NumPy at the route's (m, n); the operand roundings on hand-picked
bit patterns; each CUDA kernel instance through the emulator of
tests/utils/cuda_emu (its exact copies of the DMMA, TF32 and bf16 MMA
fragments) against its plain version; the tool's error, verdict and bound
paths; chip_smoke.py's kernels-line entries."""
import contextlib
import ctypes
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import ninpol_tpu  # noqa: F401  (x64 and the matmul precision)
from ninpol_tpu.ops import pallas_chol
from ninpol_tpu_torch.ops import mxu_probes as mp
from ninpol_tpu_torch.tools import SITES, mxu_probes as tool, site_of
from tests.test_torch_gls_solve import _port_chunk
from tests.utils import cuda_emu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 products against another order of the same sums, per node over
# the largest entry of the operands' magnitude product (tool.TOL, as
# kernel_stages.CUT_TOL holds the float32 stages)
TOL = tool.TOL
NT = mp.NT
M, N, SPLIT = 30, 16, 16   # the interpret-mode tile: n_pad = 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's default of one
    thread per core would oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _node_err(x, ref, scale):
    """max over nodes of max|x - ref| / max|scale|."""
    x, ref, scale = (np.asarray(a, np.float64).reshape(len(a), -1)
                     for a in (x, ref, scale))
    return float((np.abs(x - ref).max(1) / np.abs(scale).max(1)).max())


def _inputs(m, n, B, seed=0):
    """float32 A (B, m, n) and a general Li (B, n, n), standard normal x
    0.1 as the TPU probes make them, and the operands' magnitude products
    of the Gram, Q and G2."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((B, m, n)) * 0.1).astype(np.float32)
    Li = (rng.standard_normal((B, n, n)) * 0.1).astype(np.float32)
    aA = np.abs(A).astype(np.float64)
    aQ = aA @ np.abs(Li).astype(np.float64).transpose(0, 2, 1)
    scales = {"gram": aA.transpose(0, 2, 1) @ aA, "q": aQ,
              "gram2": aQ.transpose(0, 2, 1) @ aQ}
    return A, Li, scales


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# operand roundings
# ---------------------------------------------------------------------------
def _bits(*u):
    return torch.tensor(np.array(u, dtype=np.uint32).view(np.int32))


def test_tf32_rounds_to_nearest_ties_away():
    """cvt.rna.tf32.f32 keeps 10 fraction bits, to nearest with ties away
    from zero (either sign): a tie rounds the magnitude up, below half
    down, above half up, a carry runs into the exponent, and infinities
    and NaNs pass; split_tf32's lo is exactly x - hi, itself TF32."""
    x = _bits(0x3F801000, 0x3F800FFF, 0x3F801001, 0xBF801000, 0x3F803000,
              0x3FFFF000, 0x7F800000, 0xFF800000, 0x7FC00001, 0x00001000)
    want = _bits(0x3F802000, 0x3F800000, 0x3F802000, 0xBF802000, 0x3F804000,
                 0x40000000, 0x7F800000, 0xFF800000, 0x7FC00001, 0x00002000)
    got = mp.round_tf32(x.view(torch.float32)).view(torch.int32)
    assert torch.equal(got, want)
    v = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi, lo = mp.split_tf32(v)
    assert torch.equal(hi + lo, v - (v - hi - lo))
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((v - hi - lo).abs() <= 2.0 ** -21 * v.abs()).all()


def test_bf16_rounds_to_nearest_ties_even():
    """cvt.rn.bf16.f32 keeps 7 fraction bits, to nearest with ties to even:
    a tie goes to the even neighbour (down from ...0, up from ...1),
    either sign, with a carry into the exponent; NaNs stay NaN; and it
    agrees with torch's own float32 -> bfloat16 cast everywhere."""
    x = _bits(0x3F808000, 0x3F818000, 0x3F807FFF, 0x3F808001, 0xBF818000,
              0x3FFF8000, 0x7F800000, 0x7FC00000)
    want = _bits(0x3F800000, 0x3F820000, 0x3F800000, 0x3F810000, 0xBF820000,
                 0x40000000, 0x7F800000, 0x7FC00000)
    got = mp.round_bf16(x.view(torch.float32)).view(torch.int32)
    assert torch.equal(got, want)
    v = torch.randn(4096, generator=torch.Generator().manual_seed(1)) * 1e3
    assert torch.equal(mp.round_bf16(v), v.to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# plain versions against ninpol_tpu
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tpu_bodies():
    """One NT-node tile at (M, N) through the TPU probes' bodies, written
    out in one interpret-mode pallas_call: the transposes (mxu_probe.py:
    108, :150), _gram_mxu (pallas_chol.py:346), the Gram at HIGHEST (:123)
    and at bf16 with the operands cast explicitly (:138: XLA on the CPU
    would take DEFAULT in full float32), the round trip (:166), Q (:185),
    the composite's G1 and G2 (:215) and the split Gram (r5_mxu_shapes.py
    :67-82).  Node-minor inputs, as the probes take them."""
    A, Li, scales = _inputs(M, N, NT)
    G = np.einsum("bmi,bmj->bij", A, A).astype(np.float32)
    f32, HI = jnp.float32, jax.lax.Precision.HIGHEST

    def dot(x, y, contract, **kw):
        return jax.lax.dot_general(x, y, (contract, ((0,), (0,))),
                                   preferred_element_type=f32, **kw)

    def kern(a_ref, li_ref, g_ref, tr_ref, bt_ref, gm_ref, gh_ref, gb_ref,
             rt_ref, q_ref, g1_ref, g2_ref, sp_ref):
        at = jnp.transpose(a_ref[0], (2, 0, 1))              # :108
        tr_ref[0] = at
        bt_ref[0] = jnp.transpose(g_ref[0], (1, 2, 0))       # :150
        pallas_chol._gram_mxu(at, gm_ref.at[0], N, jnp.zeros((N, NT), f32))
        g = dot(at, at, ((1,), (1,)), precision=HI)          # :123
        gh_ref[0] = g
        atb = at.astype(jnp.bfloat16)                        # :138
        gb_ref[0] = dot(atb, atb, ((1,), (1,)))
        rt_ref[0] = jnp.transpose(g, (1, 2, 0))              # :166
        lt = jnp.transpose(li_ref[0], (2, 0, 1))             # :185, :215
        q = dot(at, lt, ((2,), (2,)), precision=HI)
        q_ref[0] = q
        g1_ref[0] = jnp.transpose(g, (1, 2, 0))
        g2_ref[0] = jnp.transpose(dot(q, q, ((1,), (1,)), precision=HI),
                                  (1, 2, 0))
        s1, s2 = at[:, :SPLIT, :], at[:, SPLIT:, :]          # r5 :67-82
        sp_ref[0] = jnp.transpose(dot(s1, s1, ((1,), (1,)), precision=HI)
                                  + dot(s2, s2, ((1,), (1,)), precision=HI),
                                  (1, 2, 0))

    def sp(*dims):
        return pl.BlockSpec((1,) + dims, lambda i: (i,) + (i * 0,) * len(dims),
                            memory_space=pltpu.VMEM)

    outs = [((NT, M, N)), (N, N, NT), (N, N, NT), (NT, N, N), (NT, N, N),
            (N, N, NT), (NT, M, N), (N, N, NT), (N, N, NT), (N, N, NT)]
    call = pl.pallas_call(
        kern, grid=(1,), in_specs=[sp(M, N, NT), sp(N, N, NT), sp(NT, N, N)],
        out_specs=[sp(*o) for o in outs],
        out_shape=[jax.ShapeDtypeStruct((1,) + o, f32) for o in outs],
        interpret=True)
    Am = np.asarray(mp.node_transpose_reference(_t(A), "out"))
    Lm = np.asarray(mp.node_transpose_reference(_t(Li), "out"))
    res = [np.asarray(r)[0] for r in call(jnp.asarray(Am), jnp.asarray(Lm),
                                          jnp.asarray(G[None]))]
    names = ("tr", "bt", "gm", "gh", "gb", "rt", "q", "g1", "g2", "sp")
    return A, Li, G, scales, dict(zip(names, res))


def _major(x):
    """A node-minor (n, n, NT) tile node-major."""
    return np.transpose(x, (2, 0, 1))


def test_transposes_match_the_probe_bodies(tpu_bodies):
    """node_transpose's plain version moves what mxu_probe.py's
    transposes move, bit for bit, both ways."""
    A, _, G, _, out = tpu_bodies
    Am = mp.node_transpose_reference(_t(A), "out")
    assert np.array_equal(mp.node_transpose_reference(Am, "in").numpy(),
                          out["tr"])
    assert np.array_equal(
        mp.node_transpose_reference(_t(G), "out").numpy()[0], out["bt"])


@pytest.mark.parametrize("precision", mp.PRECISIONS)
def test_gram_plain_matches_gram_mxu(tpu_bodies, precision):
    """gram_tc's plain version against the TPU's Grams: the float32-true
    forms against _gram_mxu, the HIGHEST dot and the round trip; bf16
    against the dot of bf16-cast operands (the TPU's DEFAULT)."""
    A, _, _, scales, out = tpu_bodies
    got = mp.gram_tc_reference(_t(A), precision).numpy()
    if precision == "bf16":
        assert _node_err(got, out["gb"], scales["gram"]) < TOL
        return
    for ref in (_major(out["gm"]), out["gh"], _major(out["rt"])):
        assert _node_err(got, ref, scales["gram"]) < TOL


@pytest.mark.parametrize("precision", tool.FLOAT32_TRUE)
def test_q_composite_and_split_match_the_probe_bodies(tpu_bodies, precision):
    """q_tc's, gram_q_gram_tc's and the split Gram's plain versions against
    mxu_probe.py's Q and composite and r5_mxu_shapes.py's split form;
    node-minor through node_transpose's plain version."""
    A, Li, _, scales, out = tpu_bodies
    Am = mp.node_transpose_reference(_t(A), "out")
    Lm = mp.node_transpose_reference(_t(Li), "out")
    q = mp.q_tc_reference(_t(A), _t(Li), precision).numpy()
    assert _node_err(q, out["q"], scales["q"]) < TOL
    g1, g2 = mp._minor_call(
        lambda X, L: mp.gram_q_gram_tc_reference(X, L, precision), "minor",
        None, Am, Lm)
    assert _node_err(_major(g1.numpy()[0]), _major(out["g1"]),
                     scales["gram"]) < TOL
    assert _node_err(_major(g2.numpy()[0]), _major(out["g2"]),
                     scales["gram2"]) < TOL
    sp = mp.gram_tc_reference(_t(A), precision, SPLIT).numpy()
    assert _node_err(sp, _major(out["sp"]), scales["gram"]) < TOL


@pytest.mark.parametrize("precision", tool.FLOAT32_TRUE)
def test_plain_matches_gram_f32_and_round2_kernels(monkeypatch, precision):
    """gram_tc's and gram_q_gram_tc's plain versions against ninpol_tpu's
    gram_f32 and round2_gram_f32 Pallas kernels, their TPU branch in
    interpret mode (forced on the CPU for the call only), on the same
    inputs: G1 and G2 = (A Li^T)^T (A Li^T)."""
    A, Li, scales = _inputs(M, N, pallas_chol.NB)
    with monkeypatch.context() as mpatch:
        mpatch.setattr(jax, "default_backend", lambda: "tpu")
        mpatch.setattr(pallas_chol, "INTERPRET", True)
        g1 = np.asarray(pallas_chol.gram_f32(jnp.asarray(A)))
        g2 = np.asarray(pallas_chol.round2_gram_f32(jnp.asarray(A),
                                                    jnp.asarray(Li)))
    got1, got2 = mp.gram_q_gram_tc_reference(_t(A), _t(Li), precision)
    assert _node_err(got1.numpy(), g1, scales["gram"]) < TOL
    assert _node_err(got2.numpy(), g2, scales["gram2"]) < TOL
    assert _node_err(mp.gram_tc_reference(_t(A), precision).numpy(), g1,
                     scales["gram"]) < TOL


@pytest.mark.parametrize("m,n", [(132, 73), (108, 37)],
                         ids=["24x36", "12x24"])
def test_plain_versions_match_float64(m, n):
    """Each plain version at the route's classes against float64 NumPy on
    the same float32 operands (bf16: on the operands rounded to bf16):
    the float32-true forms within TOL, as the sums of float32."""
    A, Li, scales = _inputs(m, n, 4)
    A64, Li64 = A.astype(np.float64), Li.astype(np.float64)
    Q64 = A64 @ Li64.transpose(0, 2, 1)
    for p in tool.FLOAT32_TRUE:
        assert _node_err(mp.gram_tc_reference(_t(A), p).numpy(),
                         A64.transpose(0, 2, 1) @ A64, scales["gram"]) < TOL
        assert _node_err(mp.q_tc_reference(_t(A), _t(Li), p).numpy(), Q64,
                         scales["q"]) < TOL
        _, g2 = mp.gram_q_gram_tc_reference(_t(A), _t(Li), p)
        assert _node_err(g2.numpy(), Q64.transpose(0, 2, 1) @ Q64,
                         scales["gram2"]) < TOL
    Ab = mp.round_bf16(_t(A)).numpy().astype(np.float64)
    assert _node_err(mp.gram_tc_reference(_t(A), "bf16").numpy(),
                     Ab.transpose(0, 2, 1) @ Ab, scales["gram"]) < TOL
    # bf16 is the coarse one: ~1e-3 of the scale from the float32 operands'
    bf = _node_err(mp.gram_tc_reference(_t(A), "bf16").numpy(),
                   A64.transpose(0, 2, 1) @ A64, scales["gram"])
    assert 1e-4 < bf < 1e-2


def test_wrappers_run_plain_versions_on_cpu():
    """On CPU tensors each wrapper is its plain version and launches
    nothing; node-minor outputs are zero past ``nodes``; arguments the
    kernels do not take raise."""
    A, Li, _ = _inputs(M, 19, 3)
    A, Li = _t(A), _t(Li)
    Am, Lm = (mp.node_transpose(x, "out") for x in (A, Li))
    before = [w.launches for w in mp.KERNELS]
    assert torch.equal(mp.node_transpose(Am, "in", 3), A)
    assert torch.equal(mp.gram_tc(A, "tf32x3"),
                       mp.gram_tc_reference(A, "tf32x3"))
    Gm = mp.gram_tc(Am, "dmma", "minor", split=7, nodes=3)
    assert torch.equal(mp.node_transpose(Gm, "in", 3),
                       mp.gram_tc_reference(A, "dmma", 7))
    assert not mp.node_transpose(Gm, "in")[3:].any()
    assert torch.equal(mp.q_tc(A, Li), mp.q_tc_reference(A, Li))
    g1, g2 = mp.gram_q_gram_tc(Am, Lm, "tf32x3", "minor", nodes=3)
    r1, r2 = mp.gram_q_gram_tc_reference(A, Li, "tf32x3")
    assert torch.equal(mp.node_transpose(g2, "in", 3), r2)
    assert [w.launches for w in mp.KERNELS] == before
    for bad in (lambda: mp.gram_tc(A, "fp16"),
                lambda: mp.gram_tc(Am, "bf16", "minor"),
                lambda: mp.q_tc(A, Li, "bf16"),
                lambda: mp.gram_tc(A, split=M),
                lambda: mp.gram_tc(Am, "dmma", "minor", nodes=NT + 1),
                lambda: mp.gram_q_gram_tc(A, Li[:, :-1, :-1]),
                lambda: mp.node_transpose(A, "sideways"),
                lambda: mp.gram_tc(torch.zeros((1, 4, 129)))):
        with pytest.raises(ValueError):
            bad()


# ---------------------------------------------------------------------------
# the CUDA kernels, emulated on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    if cuda_emu.gxx() is None:
        pytest.skip("needs g++ to build the emulated kernels")
    return cuda_emu.build("mxu_probes", str(tmp_path_factory.mktemp("emu")),
                          mp._bind)


def _emulate(monkeypatch, lib):
    """The wrappers launching the emulated kernels on CPU tensors."""
    monkeypatch.setattr(mp.library, "lib", lib)
    monkeypatch.setattr(mp, "on_card", lambda x, name: True)
    monkeypatch.setattr(mp, "stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())


@pytest.fixture
def emu(emu_lib, monkeypatch):
    _emulate(monkeypatch, emu_lib)
    return emu_lib


# every instance of the tool, and the sweep's split Gram, at (30, 19) on
# two nodes; every product instance also at the interior class (132, 73)
# on one node (node_transpose there would emulate ~1,200 blocks of 256
# threads for one 128-node tile)
INSTANCES = (*tool.CONFIGS,
             *(("gram_tc", {"precision": p, "layout": "minor", "split": 8})
               for p in tool.FLOAT32_TRUE))
CASES = [(k, kw, 30, 19, 2) for k, kw in INSTANCES] + [
    (k, kw, 132, 73, 1) for k, kw in INSTANCES if k != "node_transpose"]


@pytest.mark.parametrize(
    "kernel,kw,m,n,B", CASES,
    ids=[f"{m}x{n}-" + tool.label(k, kw) + ("-split" if "split" in kw else "")
         for k, kw, m, n, _ in CASES])
def test_kernel_matches_plain_version(emu, kernel, kw, m, n, B):
    """Each kernel instance on float32 inputs, against its plain version:
    node_transpose bit for bit, the products per node within TOL of the
    operands' magnitude product; one launch counted for its instance.
    n = 19 pads to 24 for DMMA's tiles and to 32 for TF32's rows, m = 30
    leaves a ragged row block; (132, 73) is the interior class, one node
    (node-minor: one real node of its tile of 128)."""
    A, Li, scales = _inputs(m, n, B)
    t = {"As": _t(A), "Li1": _t(Li),
         "G1": mp.gram_tc_reference(_t(A), "dmma")}
    t["As_minor"] = mp.node_transpose_reference(t["As"], "out")
    t["Li1_minor"] = mp.node_transpose_reference(t["Li1"], "out")
    scales = {k: torch.from_numpy(v) for k, v in scales.items()}
    name = tool.label(kernel, {k: v for k, v in kw.items() if k != "split"})
    before = getattr(mp, kernel).launches_by[name]
    if "split" in kw:
        got = mp.gram_tc(t["As_minor"], kw["precision"], "minor", kw["split"],
                         nodes=B)
        got = (mp.node_transpose_reference(got, "in", B),)
        ref = (mp.gram_tc_reference(t["As"], kw["precision"], kw["split"]),)
        e = tool.errors("gram_tc", kw, got, ref, scales,
                        {"gram": t["As"].double().transpose(1, 2)
                         @ t["As"].double()})
    else:
        got = tool.major(tool.run(kernel, kw, t), kernel, kw, B)
        ref = tool.major(tool.run(kernel, kw, t, plain=True), kernel, kw, B)
        A64, Li64 = t["As"].double(), t["Li1"].double()
        Q64 = A64 @ Li64.transpose(1, 2)
        e = tool.errors(kernel, kw, got, ref, scales,
                        {"gram": A64.transpose(1, 2) @ A64, "q": Q64,
                         "gram2": Q64.transpose(1, 2) @ Q64})
    assert getattr(mp, kernel).launches_by[name] == before + 1
    assert e["max_err"] <= e["tol"], e
    if kernel == "node_transpose":
        assert e["exact"]
    elif kw["precision"] != "bf16":
        assert e["f64_err"] < TOL
    if kw.get("layout") == "minor":
        out = tool.run(kernel, kw, t)
        outs = out if isinstance(out, tuple) else (out,)
        for o in outs:
            assert not mp.node_transpose_reference(o, "in")[B:].any()


# the persistent bodies of q_tc and gram_q_gram_tc on a grid of ``blocks``
# blocks: (30, 19) on 3 and 5 nodes over 2 blocks (uneven node counts, spans
# from every 4-byte boundary), the interior class on 3 nodes over 2 blocks
# (q_tc's Q staged over A and stored in bulk), a node-minor composite whose
# second tile holds 3 real nodes, q_tc past n = 80 (A's fragments by chunks)
# and at m = 61 (row tiles split into column units)
PERSISTENT = [(k, p, lay, m, n, B, blocks)
              for m, n, B, blocks in ((30, 19, 3, 2), (30, 19, 5, 2))
              for k, lay in (("q_tc", "major"), ("gram_q_gram_tc", "major"),
                             ("gram_q_gram_tc", "minor"))
              for p in tool.FLOAT32_TRUE] + [
    ("q_tc", "dmma", "major", 132, 73, 3, 2),
    ("q_tc", "tf32x3", "major", 132, 73, 3, 2),
    ("gram_q_gram_tc", "dmma", "major", 132, 73, 3, 2),
    ("gram_q_gram_tc", "dmma", "minor", 30, 19, NT + 3, 3),
    ("gram_q_gram_tc", "tf32x3", "minor", 30, 19, NT + 3, 3),
    ("q_tc", "dmma", "major", 20, 90, 3, 2),
    ("q_tc", "tf32x3", "major", 61, 33, 3, 2)]


@pytest.mark.parametrize(
    "kernel,precision,layout,m,n,B,blocks", PERSISTENT,
    ids=[f"{k}-{p}-{lay}-{m}x{n}-B{B}-g{g}"
         for k, p, lay, m, n, B, g in PERSISTENT])
def test_persistent_bodies_match_plain(emu, kernel, precision, layout, m, n,
                                       B, blocks):
    """q_tc and gram_q_gram_tc on ``blocks`` persistent blocks against their
    plain versions within TOL of the operands' magnitude product, DMMA also
    against float64; node-minor slots past B zero; one launch counted."""
    A, Li, scales = _inputs(m, n, B, seed=B)
    A, Li = _t(A), _t(Li)
    scales = {k: torch.from_numpy(v) for k, v in scales.items()}
    kw = {"precision": precision} if kernel == "q_tc" else {
        "precision": precision, "layout": layout}
    name = tool.label(kernel, kw)
    before = getattr(mp, kernel).launches_by[name]
    if kernel == "q_tc":
        got = (mp.q_tc(A, Li, precision, blocks=blocks),)
    else:
        if layout == "minor":
            X, L = (mp.node_transpose_reference(x, "out") for x in (A, Li))
            outs = mp.gram_q_gram_tc(X, L, precision, "minor", nodes=B,
                                     blocks=blocks)
            for o in outs:
                assert not mp.node_transpose_reference(o, "in")[B:].any()
            got = tuple(mp.node_transpose_reference(o, "in", B) for o in outs)
        else:
            got = mp.gram_q_gram_tc(A, Li, precision, blocks=blocks)
    assert getattr(mp, kernel).launches_by[name] == before + 1
    ref = ((mp.q_tc_reference(A, Li, precision),) if kernel == "q_tc"
           else mp.gram_q_gram_tc_reference(A, Li, precision))
    A64, Li64 = A.double(), Li.double()
    Q64 = A64 @ Li64.transpose(1, 2)
    e = tool.errors(kernel, kw, got, ref, scales,
                    {"gram": A64.transpose(1, 2) @ A64, "q": Q64,
                     "gram2": Q64.transpose(1, 2) @ Q64})
    assert e["max_err"] <= TOL, e
    if precision == "dmma":
        assert e["f64_err"] < 1e-7, e


# gram_tc's persistent bodies on a grid of ``blocks`` blocks, (layout,
# precision, m, n, split, B, blocks): node-major at (30, 19) on 3 and 5 nodes
# over 2 blocks in every precision (spans from every 4-byte boundary), the
# interior class on 3 nodes over 2 blocks (G staged, out by a bulk store),
# split at row 8, past n = 80 (three super tiles a warp) and a node taller
# than shared memory (its rows in chunks); node-minor on a
# first tile's 16 groups and a second tile of 3 real nodes, split at row 8,
# past n = 80, and at n = 128 (two copy buffers; five items a DMMA group)
GRAM = ([("major", p, 30, 19, 0, B, 2) for B in (3, 5) for p in mp.PRECISIONS]
        + [("major", p, 132, 73, 0, 3, 2) for p in mp.PRECISIONS]
        + [("major", p, 30, 19, 8, 3, 2) for p in tool.FLOAT32_TRUE]
        + [("major", p, 20, 90, 0, 3, 2) for p in tool.FLOAT32_TRUE]
        + [("major", "dmma", 3000, 19, 0, 2, 1)]
        + [("minor", p, 30, 19, 0, NT + 3, 3) for p in tool.FLOAT32_TRUE]
        + [("minor", p, m, n, s, 11, 2) for p in tool.FLOAT32_TRUE
           for m, n, s in ((30, 19, 8), (20, 90, 0), (20, 128, 0))])


@pytest.mark.parametrize(
    "layout,precision,m,n,split,B,blocks", GRAM,
    ids=[f"{lay}-{p}-{m}x{n}" + (f"@{s}" if s else "") + f"-B{B}-g{g}"
         for lay, p, m, n, s, B, g in GRAM])
def test_gram_bodies_match_plain(emu, layout, precision, m, n, split, B,
                                 blocks):
    """gram_tc on ``blocks`` persistent blocks against its plain version
    within TOL of the operands' magnitude product, DMMA also within 1e-7 of
    float64; node-minor slots past B zero; one launch counted."""
    A, _, scales = _inputs(m, n, B, seed=B + m)
    A = _t(A)
    name = tool.label("gram_tc", {"precision": precision, "layout": layout})
    before = mp.gram_tc.launches_by[name]
    if layout == "minor":
        out = mp.gram_tc(mp.node_transpose_reference(A, "out"), precision,
                         "minor", split, nodes=B, blocks=blocks)
        assert not mp.node_transpose_reference(out, "in")[B:].any()
        got = mp.node_transpose_reference(out, "in", B)
    else:
        got = mp.gram_tc(A, precision, split=split, blocks=blocks)
    assert mp.gram_tc.launches_by[name] == before + 1
    ref = mp.gram_tc_reference(A, precision, split)
    A64 = A.double()
    e = tool.errors("gram_tc", {"precision": precision}, (got,), (ref,),
                    {"gram": torch.from_numpy(scales["gram"])},
                    {"gram": A64.transpose(1, 2) @ A64})
    assert e["max_err"] <= TOL, e
    if precision == "dmma":
        assert e["f64_err"] < 1e-7, e


def test_gram_request_changes_no_bit(emu):
    """A shared memory request (kernel 1's at (24, 36), and one that
    deepens the node-major ring at the interior class) launches the larger
    of it and the kernel's need, and gives the same G to the bit,
    node-major and node-minor."""
    for m, n, request in ((30, 19, 105824), (132, 73, 200000)):
        A, _, _ = _inputs(m, n, 3)
        A = _t(A)
        Am = mp.node_transpose_reference(A, "out")
        for layout, X in (("major", A), ("minor", Am)):
            need = mp.occupancy("gram_tc", n, layout=layout, m=m)
            occ = mp.occupancy("gram_tc", n, layout=layout, m=m,
                               smem_bytes=request)
            assert occ["smem_bytes"] == max(request, need["smem_bytes"])
            base = mp.gram_tc(X, layout=layout, nodes=3 if Am is X else None,
                              blocks=2)
            at = mp.gram_tc(X, layout=layout, nodes=3 if Am is X else None,
                            blocks=2, smem_bytes=request)
            assert torch.equal(base, at), (m, n, layout)
    with pytest.raises(ValueError):
        mp.gram_tc(A, smem_bytes=-1)


def test_persistent_launch_checks(emu):
    """blocks below 1 raise; on the card q_tc's A and output must agree
    modulo 16 bytes (its Q is staged over A's span): a launch that breaks
    it is refused, not run."""
    A, Li, _ = _inputs(30, 19, 2)
    A, Li = _t(A), _t(Li)
    with pytest.raises(ValueError):
        mp.q_tc(A, Li, blocks=0)
    with pytest.raises(ValueError):
        mp.gram_q_gram_tc(A, Li, blocks=-1)
    buf = torch.zeros(A.numel() + 1)
    shifted = buf[1:].view(A.shape)
    shifted.copy_(A)
    with pytest.raises(RuntimeError):
        mp.q_tc(shifted, Li)


_BULK = r"""
#include <cuda_runtime.h>
#include "bulk_copy.cuh"
using namespace bulk_copy;

// two nodes of ``count`` floats each, from x + off[k]: thread 0 brings the
// 16-byte span that covers node k into shared memory on one mbarrier
// (phases 0 and 1), every thread doubles its share into a staging area at
// the same offset modulo 16 bytes, and thread 0 stores the node to y +
// off[k] by one bulk store of the aligned interior and plain stores of the
// floats either side
__global__ void span_kernel(const float* x, float* y, const long long* off, int count) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar[1];
  float* const raw = smem;
  float* const stage = smem + (count + 11) / 4 * 4;   // 16-byte aligned, past raw's span
  // every copy is issued before the barrier that precedes its wait
  auto load = [&](int k) {
    const float* src = x + off[k];
    const int h = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    bulk_load(raw, src - h, (unsigned)((h + count + 3) / 4 * 16), bar);
  };
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    load(0);
  }
  __syncthreads();
  for (int k = 0; k < 2; ++k) {
    mbar_wait(bar, k & 1);
    const int h = (int)((reinterpret_cast<uintptr_t>(x + off[k]) >> 2) & 3);
    float* const out = stage + (int)((reinterpret_cast<uintptr_t>(y + off[k]) >> 2) & 3);
    for (int i = threadIdx.x; i < count; i += blockDim.x) out[i] = 2.f * raw[h + i];
    fence_async_shared();
    __syncthreads();
    if (threadIdx.x == 0) {
      float* const dst = y + off[k];
      const int lo = min((4 - (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3)) & 3, count);
      const int hi = lo + (count - lo) / 4 * 4;
      for (int i = 0; i < lo; ++i) dst[i] = out[i];
      for (int i = hi; i < count; ++i) dst[i] = out[i];
      if (hi > lo) bulk_store(dst + lo, out + lo, 4 * (hi - lo));
      bulk_commit();
      bulk_wait_read();
      if (k == 0) load(1);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) bulk_wait();
}

extern "C" int span_copy(const float* x, float* y, const long long* off, int count) {
  span_kernel<<<1, 64, (2 * count + 24) * sizeof(float), nullptr>>>(x, y, off, count);
  return 0;
}
"""


def test_emulated_bulk_store_and_span_helpers(tmp_path):
    """csrc/bulk_copy.cuh in a block under the emulator: a node's span in
    by cp.async.bulk on an mbarrier whose phase flips node by node, out by
    a bulk store of the 16-byte-aligned interior and plain stores either
    side, with the fence, the group commit and its waits; spans from each
    4-byte boundary come back doubled and nothing outside them changes."""
    if cuda_emu.gxx() is None:
        pytest.skip("needs g++ to build the emulated kernels")

    def bind(lib):
        vp = ctypes.c_void_p
        lib.span_copy.argtypes = [vp, vp, vp, ctypes.c_int]

    lib = cuda_emu.build_text(_BULK, "bulk", str(tmp_path), bind)
    x = torch.arange(256, dtype=torch.float32) + 1
    for count in (3, 21, 64):
        for first, second in ((0, 101), (1, 150), (2, 7), (3, 170)):
            y = torch.full((256,), -1.0)
            off = torch.tensor([first, second], dtype=torch.int64)
            lib.span_copy(x.data_ptr(), y.data_ptr(), off.data_ptr(), count)
            want = torch.full((256,), -1.0)
            for o in (first, second):
                want[o:o + count] = 2 * x[o:o + count]
            assert torch.equal(y, want), (count, first, second)


_ATOMIC = r"""
#include <cuda_runtime.h>

// every thread of 4 warps adds 1 (float) and (1, 2, 3, 4) (float4) to the
// same two addresses, and its lane to a word of its own
__global__ void atomic_kernel(float* x, float4* y, float* z) {
  atomicAdd(x, 1.f);
  atomicAdd(y, make_float4(1.f, 2.f, 3.f, 4.f));
  atomicAdd(z + threadIdx.x, (float)(threadIdx.x & 31));
}

extern "C" int atomic_add(float* x, float4* y, float* z) {
  atomic_kernel<<<2, 128, 0, nullptr>>>(x, y, z);
  return 0;
}
"""


def test_emulated_atomic_add(tmp_path):
    """The emulator's atomicAdd on float and float4 (the node-minor Gram's
    split adds its second part so): concurrent additions by the warps of
    two blocks to one address all land, each returns nothing lost."""
    if cuda_emu.gxx() is None:
        pytest.skip("needs g++ to build the emulated kernels")

    def bind(lib):
        vp = ctypes.c_void_p
        lib.atomic_add.argtypes = [vp, vp, vp]

    lib = cuda_emu.build_text(_ATOMIC, "atomic", str(tmp_path), bind)
    x, y, z = torch.zeros(1), torch.full((4,), 0.5), torch.zeros(128)
    lib.atomic_add(x.data_ptr(), y.data_ptr(), z.data_ptr())
    assert x.item() == 256.0
    assert torch.equal(y, torch.tensor([256.5, 512.5, 768.5, 1024.5]))
    assert torch.equal(z, 2 * (torch.arange(128) % 32).float())


def test_tool_errors_on_route_chunks(emu_lib, monkeypatch):
    """The tool's inputs and error path on the route's own chunks
    (tetra_mesh(3)): the unfused route's tensors from ``prepare`` for both
    classes (plain versions: CPU tensors), then, on two nodes of the
    Neumann class (m, n) = (108, 37), every instance emulated and held to
    its plain version by ``probe_errors``, a launch counted for each; the
    precision verdict's errors merged in."""
    chunks = []
    for neumann in (False, True):
        inp = _port_chunk(neumann=neumann)
        c = {"E": inp["dk"].shape[1], "F": inp["l1"].shape[1],
             "with_neumann": neumann}
        chunks.append((c, inp, None))
    prepared = tool.prepare(chunks)
    assert [(h["m"], h["n"]) for h, _ in prepared] == [(132, 73), (108, 37)]
    for head, t in prepared:
        assert t["As_minor"].shape == (-(-head["chunk"] // NT), head["m"],
                                       head["n"], NT)
        assert torch.equal(mp.node_transpose_reference(
            t["Li1_minor"], "in", head["chunk"]), t["Li1"])
    head, t = prepared[1]
    t = {k: v[:2].contiguous() for k, v in t.items()
         if not k.endswith("_minor")}
    t["As_minor"] = mp.node_transpose(t["As"], "out")
    t["Li1_minor"] = mp.node_transpose(t["Li1"], "out")
    _emulate(monkeypatch, emu_lib)
    tool.reset_counts()
    errors = tool.probe_errors([(dict(head, chunk=2, k1_request=105824), t)])
    assert all(n > 0 for n in tool.launch_counts().values())
    for errs in errors:
        assert set(errs) == {tool.label(k, w) for k, w in tool.CONFIGS}
        for name, e in errs.items():
            assert e["max_err"] <= e["tol"], (name, e)
            assert e["nodes"] == 2
        for k, w in tool.K1_CONFIGS:
            e = errs[tool.label(k, w)]
            assert e["max_err_k1"] <= e["tol"] and e["f64_err_k1"] < 1e-7, e
    row = {"kernels": {k: dict(e, ms=1.0) for k, e in errors[0].items()},
           "verdicts": {"precision": {"faster": "tf32x3"}}}
    tool.finish_verdicts(row)
    assert row["verdicts"]["precision"]["faster_within_tol"]


# ---------------------------------------------------------------------------
# verdicts, bounds, the kernels line, the sites
# ---------------------------------------------------------------------------
def _row(ms):
    return {"E": 24, "F": 36, "with_neumann": False, "chunk": 32768,
            "kernels": {tool.label(k, kw): {"kernel": k, **kw, "ms": m_,
                                            "plain_ms": 9.0, "bound_ms": 0.4,
                                            "bound_by": "bytes",
                                            "library_ms": 2.6,
                                            "max_abs_err": 1e-7,
                                            "max_err": 1e-7, "f64_err": 1e-7}
                        for (k, kw), m_ in zip(tool.CONFIGS, ms)},
            "standalone": {"gram_f32": 1.30, "round2_gram_f32": 3.10},
            "stages": {"gram1": 1.79, "q": 3.19, "gram2": 1.43,
                       "gram1_q_gram2": 6.41}}


# transposes, gram major dmma/tf32x3/bf16, minor dmma/tf32x3, q dmma/tf32x3,
# composite major dmma/tf32x3, minor dmma/tf32x3
MS = (0.96, 0.84, 1.9, 2.3, 1.5, 5.2, 1.2, 4.0, 4.5, 6.8, 8.1, 12.0, 4.2)


def test_verdicts_follow_the_tpu_rules():
    """mxu_probe.py's verdict on made-up times: the round trip against
    gram_f32 and the gram1 cut, each composite against the three cuts and
    gram_f32 + round2_gram_f32, per float32-true precision; the precision
    verdict's faster form and its ratio over bf16."""
    assert len(tool.CONFIGS) == 13 == len(MS)
    v = tool.verdicts(_row(MS))
    d, t = v["mxu"]["dmma"], v["mxu"]["tf32x3"]
    assert not d["round_trip_beats_gram_f32"]            # 5.2 > 1.30
    assert t["round_trip_beats_gram1_cut"]               # 1.2 < 1.79
    assert t["round_trip_beats_gram_f32"]                # 1.2 < 1.30
    assert not d["composite_major_beats_cuts"]           # 6.8 > 6.41
    assert t["composite_minor_beats_cuts"]               # 4.2 < 6.41
    assert not d["composite_major_beats_unfused"]        # 6.8 > 4.40
    assert d["composite_minor_ms"] == 12.0 and t["composite_minor_ms"] == 4.2
    assert t["composite_minor_beats_unfused"]            # 4.2 < 4.40
    assert v["mxu"]["cuts_ms"] == 6.41
    assert v["mxu"]["unfused_ms"] == pytest.approx(4.40)
    p = v["precision"]
    assert p["faster"] == "dmma" and p["over_bf16"] == pytest.approx(1.9 / 1.5)
    g = v["gram1"]                                       # no k1 time: its own
    assert g["dmma_k1_ms"] == g["dmma_ms"] == 1.9 and g["gram1_cut_ms"] == 1.79
    assert not g["k1_beats_gram_f32"] and not g["k1_beats_gram1_cut"]
    row = _row(MS)
    row["kernels"]["gram_tc[dmma,major]"]["ms_k1"] = 1.0
    g = tool.verdicts(row)["gram1"]
    assert g["k1_beats_gram_f32"] and g["k1_beats_gram1_cut"]
    assert tool.unlaunched_k1([row]) == [
        "(24, 36) gram_tc[dmma,major]: no launch at kernel 1's shared memory"]
    row["kernels"]["gram_tc[dmma,major]"]["launches_k1"] = 12
    assert tool.unlaunched_k1([row]) == []
    assert tool.failed([{"E": 24, "F": 36, "kernels": {
        "gram_tc[dmma,major]": {"max_err": 1e-7, "max_err_k1": 2e-5,
                                "tol": 1e-5}}}], []) == [
        "(24, 36) gram_tc[dmma,major] at kernel 1's shared memory: error "
        "2.000e-05 > 1e-05"]
    assert tool.failed([{"E": 24, "F": 36, "kernels": {
        "gram_tc[dmma,major]": {"max_err": 2e-5, "tol": 1e-5}}}], [])


def test_shape_verdicts_follow_the_tpu_hypotheses():
    """r5_mxu_shapes.py's H1 and H2 on made-up sweep times: 132 nearer 136
    than 128 pads, the split's ratio, 72 against 80 scaled by the work."""
    times = {"dmma": {(128, 80, 0): 3.0, (132, 80, 0): 3.3, (136, 80, 0): 3.35,
                      (168, 80, 0): 4.0, (132, 80, 128): 3.0,
                      (132, 72, 0): 2.7, (132, 128, 0): 7.0},
             "tf32x3": {(128, 80, 0): 3.0, (132, 80, 0): 3.02,
                        (136, 80, 0): 3.3, (168, 80, 0): 4.0,
                        (132, 80, 128): 3.3, (132, 72, 0): 3.0,
                        (132, 128, 0): 7.0}}
    sweep = [{"m": m, "n": n, "split": s, "precision": p, "ms": ms}
             for p, t in times.items() for (m, n, s), ms in t.items()]
    v = tool.shape_verdicts(sweep)
    assert v["dmma"]["H1_m_pads"] and not v["tf32x3"]["H1_m_pads"]
    assert v["dmma"]["split_over_unsplit"] == pytest.approx(3.0 / 3.3)
    assert not v["dmma"]["H2_n72_pads"]     # 2.7 ~ 3.3 x 0.811 = 2.68
    assert v["tf32x3"]["H2_n72_pads"]       # 3.0 ~ 3.02
    assert v["dmma"]["n128_over_n80"] == pytest.approx(7.0 / 3.3)
    assert v["dmma"]["ns_per_node"]["132x80@128"] == pytest.approx(
        3.0e6 / tool.SWEEP_NODES)
    assert {(r["m"], r["n"], r["split"]) for r in sweep} == set(tool.SHAPES)


def test_work_counts_what_the_functions_need():
    """The bounds' FLOPs, peak and bytes: the Grams on their triangle, Q
    whole (the probe's Li is general), 3 passes for tf32x3, each input
    read and each output written once, node-minor tensors whole tiles."""
    head = {"chunk": 200, "m": 132, "n": 73}
    A, sq, tiles = 132 * 73 * 4, 73 * 73 * 4, 256
    gram, q = 132 * 73 * 74, 2 * 132 * 73 * 73
    assert tool.work("gram_tc", {"precision": "dmma", "layout": "major"},
                     head) == (200 * gram, tool.PEAK_FP64, 200 * (A + sq))
    assert tool.work("gram_tc", {"precision": "tf32x3", "layout": "minor"},
                     head) == (3 * 200 * gram, tool.PEAK_TF32,
                               tiles * (A + sq))
    assert tool.work("gram_tc", {"precision": "bf16", "layout": "major"},
                     head)[1] == tool.PEAK_BF16
    assert tool.work("q_tc", {"precision": "dmma"}, head) == (
        200 * q, tool.PEAK_FP64, 200 * (2 * A + sq))
    assert tool.work("gram_q_gram_tc", {"precision": "dmma",
                                        "layout": "major"}, head) == (
        200 * (2 * gram + q), tool.PEAK_FP64, 200 * (A + 3 * sq))
    assert tool.work("node_transpose", {"direction": "in"}, head) == (
        0.0, tool.PEAK_FP64, A * (200 + tiles))
    assert tool.work("node_transpose", {"direction": "out"}, head)[2] == \
        sq * (200 + tiles)
    assert tool.work("gram_tc", {"precision": "dmma", "layout": "minor"},
                     {}, m=136, n=80, nodes=16384)[0] == 16384 * 136 * 80 * 81


def test_kernels_line_names_each_site():
    """chip_smoke.py's kernels-line entries of phase 12: one a ported
    tools/ site (eight), each with its instances' launches and its fastest
    instance's numbers on the largest class, the sweep's at (132, 80)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    small = _row([0.1 * x for x in MS])
    small.update(E=12, F=24, with_neumann=True, chunk=9579)
    table = [small, _row(MS)]
    labels = [tool.label(k, kw) for k, kw in tool.CONFIGS]
    launches = {label: i + 1 for i, label in enumerate(labels)}
    sweep = [{"m": m, "n": n, "split": s, "precision": p, "ms": 3.0 + i,
              "nodes": tool.SWEEP_NODES,
              "plain_ms": 9.0, "bound_ms": 0.5, "bound_by": "operations",
              "library_ms": 2.0, "max_abs_err": 1e-6, "max_err": 1e-7}
             for i, (p, (m, n, s)) in enumerate(
                 (p, sh) for sh in tool.SHAPES for p in tool.FLOAT32_TRUE)]
    launches[tool.SHAPES_ANSWER] = 84
    entries = smoke.mxu_entries(table, sweep, launches)
    by_site = {e["replaces"]: e for e in entries}
    assert set(by_site) == {
        f"tools/mxu_probe.py:{n}" for n in (108, 123, 138, 150, 166, 185,
                                            215)} | {"tools/r5_mxu_shapes.py:84"}
    g = by_site["tools/mxu_probe.py:123"]
    assert g["instance"] == "gram_tc[dmma,major]" and g["ms"] == 1.9
    assert g["launches"] == launches["gram_tc[dmma,major]"] + launches[
        "gram_tc[tf32x3,major]"]
    c = by_site["tools/mxu_probe.py:215"]
    assert c["instance"] == "gram_q_gram_tc[tf32x3,minor]" and c["ms"] == 4.2
    assert len(c["classes"]) == 2 * 4
    s = by_site["tools/r5_mxu_shapes.py:84"]
    assert s["ms"] == 5.0 and s["launches"] == 84
    for site in (123, 138, 166, 185, 215):
        e = by_site[f"tools/mxu_probe.py:{site}"]
        assert e["status"] == "redesigned" and e["design"]
    assert s["status"] == "redesigned" and s["design"]
    assert not [e for e in entries if "status" not in e
                and e["name"].startswith("gram_tc")]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for e in entries:
        assert keys <= set(e) and e["route"] == "cuda"
        assert e["source"] == "ninpol_tpu_torch/csrc/mxu_probes.cu"
    assert sum(e["launches"] for e in entries) == sum(launches.values())


def test_every_mxu_probe_ports_a_site():
    """Each of this file's kernels ports a mxu_probe.py or r5_mxu_shapes.py
    site that site_of finds; the two VPU baselines are answered; no site
    of these two files is queued."""
    names = {tool.answer(k, kw) for k, kw in tool.CONFIGS}
    names.add(tool.SHAPES_ANSWER)
    assert len(names) == 8
    for name in names:
        site = site_of(name)
        assert site.split("/")[1].split(":")[0] in ("mxu_probe.py",
                                                    "r5_mxu_shapes.py")
        assert getattr(mp, name.split(" (")[0]) in mp.KERNELS
    ours = {s: v for s, v in SITES.items()
            if s.split(":")[0] in ("mxu_probe.py", "r5_mxu_shapes.py")}
    assert len(ours) == 10
    assert [v[0] for v in ours.values()].count("answered") == 2
    assert all(v[0] != "queued" for v in ours.values())
