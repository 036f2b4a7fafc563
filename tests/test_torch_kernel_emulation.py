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
from ninpol_tpu_torch.ops import cuda_lib
from ninpol_tpu_torch.ops import gls_solve as gs
from ninpol_tpu_torch.tools import kernel_stages
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


@pytest.fixture(scope="module")
def emu_stages(emu, tmp_path_factory):
    """The stage-cut library (gls_solve.cu with -DGLS_SOLVE_STAGE_CUTS)."""
    out = str(tmp_path_factory.mktemp("cuda_emu_stages"))
    return cuda_emu.build("gls_solve", out, gs._bind_stages,
                          define=gs.stage_library.define)


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
    # the Gram products and prec_apply at the tet classes' (m, n):
    # (12, 24) and (24, 36)
    pytest.param(k, m, n, id=f"{k}-{m}x{n}")
    for k in ("gram_f32", "round2_gram_f32", "prec_apply_f32")
    for m, n in ((108, 37), (132, 73))])
def test_cholqr_kernel_matches_plain_version(emu, kernel, m, n):
    """Each unfused preconditioner kernel on a random, well-conditioned
    chunk (n = 29: a row stride padded to 32; the Gram products and
    prec_apply also at the route's classes), against its plain version:
    the products to TOL_F32 of the operands' magnitude product, the
    inverse factors to 1e-4 of the factor.  The default bodies of
    gram_f32 and round2_gram_f32 (registers, to n = 76) give the
    shared-memory bodies' G bit for bit: both sum in one order.  Both
    bodies of prec_apply_f32 (a warp a node, to n = 128; a block a node)
    are held to the plain version."""
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
        assert lib.gram_f32_path(n) == 2
        shared = torch.empty_like(out)
        _call(lib.gram_f32_path_launch, A, shared, None, B, m, n, 1)
        assert torch.equal(out, shared)
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
        assert lib.prec_apply_f32_path(n) == 2
        ref = cq.prec_apply_f32_reference(Lc, v)
        mag = torch.einsum("bij,bi->bj", Lc.abs(),
                           torch.einsum("bij,bj->bi", Lc.abs(), v.abs()))
        for path in (0, 1, 2):
            o = torch.empty((B, n), dtype=torch.float32)
            _call(lib.prec_apply_f32_path_launch, Lc, v, o, None, B, n, path)
            assert _scaled(o, ref, mag) < TOL_F32


@pytest.mark.parametrize("path", [1, 2])
def test_prec_apply_does_not_read_the_upper_triangle(emu, path):
    """prec_apply_f32 reads Lc as lower triangular, as the route's Lc =
    L2^-1 L1^-1 is: garbage above the diagonal (a NaN among it) gives
    the output of tril(Lc), bit for bit, on either body (n = 73, the
    interior class; B = 3, so the warp body's last block is ragged)."""
    lib = emu["cholqr"]
    B, n = 3, 73
    rng = np.random.default_rng(1)
    L = torch.as_tensor(rng.standard_normal((B, n, n)), dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((B, n)), dtype=torch.float32)
    junk = L.clone()
    junk[0, 0, n - 1] = float("nan")
    low = torch.tril(L)
    outs = []
    for Lc in (junk, low):
        outs.append(torch.empty((B, n), dtype=torch.float32))
        _call(lib.prec_apply_f32_path_launch, Lc, v, outs[-1], None, B, n,
              path)
    assert torch.equal(outs[0], outs[1])
    mag = torch.einsum("bij,bi->bj", low.abs(),
                       torch.einsum("bij,bj->bi", low.abs(), v.abs()))
    assert _scaled(outs[1], cq.prec_apply_f32_reference(low, v), mag) \
        < TOL_F32


def _solve(lib, inp, ws_floats=0, sweeps=3, rounds=2, stop=None,
           tiny=1e-12):
    """The fused kernel on CPU tensors, as ops/gls_solve.py launches it;
    with ``stop`` (a name of gls_solve.STAGES) its stage cut, through the
    stage entry of ``lib``, the stage-cut library."""
    B, E, _ = inp["dk"].shape
    F = inp["l1"].shape[1]
    f64 = torch.float64
    w, wn, rnorm = (torch.empty((B, E), dtype=f64), torch.empty(B, dtype=f64),
                    torch.empty(B, dtype=f64))
    ws = torch.empty(B * ws_floats, dtype=torch.float32) if ws_floats else None
    args = [inp[k] for k in ("dk", "l1", "l2", "t1m", "tt", "lb", "nm",
                             "pair", "ks", "cv", "fv", "isneu", "valid")]
    head = [*args, w, wn, rnorm, ws, ws_floats, B, E, F,
            int(inp["lb"] is not None), sweeps, rounds]
    if stop is None:
        _call(lib.gls_solve_launch, *head, tiny, 1.5e-5)
    else:
        _call(lib.gls_solve_stage_launch, *head, gs.STAGES.index(stop),
              tiny, 1.5e-5)
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
def test_gls_solve_one_round_matches_plain_version(emu, neumann):
    """The kernel's rounds = 1 instance (precond_rounds = 1: M from L1^-1
    alone, five sweeps) against the plain version at rounds = 1, by
    phase 4's rule: weights to 1e-10 scaled on the nodes both call
    converged, the same rnorm > 1e-11 sets.  The rank-deficient node
    does not clamp a pivot in one round: the shift keeps G1 definite.
    Few nodes: five emulated sweeps of the interior class are slow."""
    inp, _ = _sick_chunk(neumann, 8 if neumann else 4)
    wk, wnk, rk = _solve(emu["gls_solve"], inp, sweeps=5, rounds=1)
    wp, wnp, rp = gs.gls_solve_reference(**inp, sweeps=5, rounds=1)
    conv = (rk <= RNORM_TOL) & (rp <= RNORM_TOL)
    assert conv.sum().item() >= 4
    scale = max(wp[conv].abs().max().item(), 1.0)
    assert (wk - wp)[conv].abs().max().item() / scale < TOL
    assert (wnk - wnp)[conv].abs().max().item() / scale < TOL
    assert torch.equal(rk > RNORM_TOL, rp > RNORM_TOL)
    # the one-round preconditioner converges more slowly than two rounds
    _, _, r2 = gs.gls_solve_reference(**inp, sweeps=5, rounds=2)
    assert (rk[conv] > r2[conv]).any()


def _duplicate_cell(inp, b, e):
    """Node b's x- and y-gradient columns of cell e made equal (its cell
    row and every row of a face it is on): A loses rank by one there, so
    G1's pivot at column 3 e + 1 falls to about twice the shift."""
    S1, S2, Sb = gs.incidence(inp["pair"], inp["ks"], inp["cv"], inp["fv"],
                              inp["isneu"])
    faces = (S1[b, :, e] + S2[b, :, e] + Sb[b, :, e]) > 0
    inp["dk"][b, e, 1] = inp["dk"][b, e, 0]
    for key in ("l1", "l2", "t1m", "tt", "lb"):
        if inp[key] is not None:
            inp[key][b, faces, 1] = inp[key][b, faces, 0]


@pytest.mark.parametrize("rounds", [2, 1])
def test_gls_solve_clamped_pivots_in_first_and_later_blocks(emu, emu_stages,
                                                            rounds):
    """Clamped pivots in diagonal block 0 (factored before the blocked
    factor's loop) and in a later block (by its lookahead), at the
    Neumann class (n = 37, padded to 40): node 0 has cell 0's gradient
    columns made equal (pivot 1), node 1 its last valid cell's (pivot
    22, block 2), node 2 is untouched.  At tiny = 1e-3 both pivots clamp
    in both versions (the plain version's dinv1 there is 1/sqrt(tiny)),
    no node is flagged and every node converges at the route's sweeps:
    the kernel's weights within TOL of the plain version's (phase 4's
    rule), the same rnorm > RNORM_TOL sets.  The weights do not depend on
    the preconditioner, so the factors are held too: the chol1 (and chol2)
    cut's checksum to the plain version's as kernel_stages.cut_errors
    holds it, over the sum of the factor's magnitudes."""
    inp = {k: None if v is None else v[:3].clone()
           for k, v in _port_chunk(neumann=True).items()}
    last = int(inp["cv"][1].nonzero().max())
    _duplicate_cell(inp, 0, 0)
    _duplicate_cell(inp, 1, last)
    tiny, sweeps = 1e-3, 3 if rounds == 2 else 5
    S1, S2, Sb = gs.incidence(inp["pair"], inp["ks"], inp["cv"], inp["fv"],
                              inp["isneu"])
    A = gs.assemble(inp["dk"], inp["l1"], inp["l2"], inp["t1m"], inp["tt"],
                    inp["lb"], S1, S2, Sb, inp["cv"], inp["valid"])
    pc = cq.cholqr_factors(A, cq.PLAIN, tiny=tiny, rounds=rounds)
    dinv1 = pc["Li1"].diagonal(dim1=1, dim2=2)
    clamped = (dinv1 == torch.rsqrt(torch.tensor(tiny))).nonzero().tolist()
    assert clamped == [[0, 1], [1, 3 * last + 1]] and 3 * last + 1 >= 16
    exact = cq.chol_linv_f32_reference(pc["G1"].double(), tiny).sum((1, 2))
    for stop, factor in (("chol1", "Li1"), ("chol2", "Lc"))[:rounds]:
        _, _, got = _solve(emu_stages, inp, sweeps=sweeps, rounds=rounds,
                           stop=stop, tiny=tiny)
        _, _, ref = gs.gls_solve_reference(**inp, sweeps=sweeps,
                                           rounds=rounds, stop=stop,
                                           tiny=tiny)
        scale = pc[factor].abs().sum((1, 2)).double()
        tol = kernel_stages.CUT_TOL[stop]
        if stop == "chol1":
            tol = max(tol, kernel_stages.CHOL_RATIO * float(
                ((ref - exact).abs() / scale).max()))
        assert float(((got - ref).abs() / scale).max()) <= tol, stop
    wk, wnk, rk = _solve(emu["gls_solve"], inp, sweeps=sweeps, rounds=rounds,
                         tiny=tiny)
    wp, wnp, rp = gs.gls_solve_reference(**inp, sweeps=sweeps, rounds=rounds,
                                         tiny=tiny)
    assert (rk <= RNORM_TOL).all() and (rp <= RNORM_TOL).all()
    scale = max(wp.abs().max().item(), 1.0)
    assert (wk - wp).abs().max().item() / scale < TOL
    assert (wnk - wnp).abs().max().item() / scale < TOL


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
    (24, 36, 0, 105824, 2),    # the interior tet class
    (12, 24, 1, 38960, 5),     # the Neumann tet class
    (64, 96, 1, 27888, 8),     # A and the two slots in the device workspace
])
def test_gls_solve_shared_memory_per_class(emu, E, F, neumann, smem, blocks):
    """The kernel's dynamic shared memory per class and the blocks an
    H100 SM holds by shared memory and threads (228 KB, 2048 threads):
    the interior class keeps two, with A, two packed float64 triangles
    (28,160 B each at n = 73) and dinv1, dinv2 padded to pad8(n).
    Registers, which the emulator does not model (it reads 0), can lower
    the count: at 128 a thread the card holds two blocks of every
    class."""
    occ = cuda_lib.occupancy(emu["gls_solve"].gls_solve_occupancy,
                             "gls_solve occupancy", E, F, neumann, 2)
    assert (occ["smem_bytes"], occ["blocks_per_sm"]) == (smem, blocks)
    assert occ["threads"] == 256
    assert (occ["registers"], occ["local_bytes"]) == (0, 0)


class CutRuns:
    """Per (neumann, rounds): the first node of a tetra_mesh(3) class
    chunk and a second one made invalid (a cut writes zeros there, as the
    kernel does), with the production kernel's outputs on them at the
    route's sweeps; built on first use.  One valid node: every emulated
    barrier costs a scheduler round trip when the suite runs in parallel
    workers."""

    def __init__(self, lib):
        self.lib = lib
        self._made = {}

    def __call__(self, neumann, rounds):
        if (neumann, rounds) not in self._made:
            inp = {k: None if v is None else v[:2].clone()
                   for k, v in _port_chunk(neumann=neumann).items()}
            inp["valid"][-1] = False
            sweeps = 3 if rounds == 2 else 5
            prod = _solve(self.lib, inp, sweeps=sweeps, rounds=rounds)
            self._made[(neumann, rounds)] = (inp, sweeps, prod)
        return self._made[(neumann, rounds)]


@pytest.fixture(scope="module")
def cut_runs(emu):
    return CutRuns(emu["gls_solve"])


@pytest.mark.parametrize("rounds", [2, 1])
@pytest.mark.parametrize("neumann", [False, True])
def test_gls_solve_all_cut_is_the_production_kernel(emu_stages, cut_runs,
                                                    neumann, rounds):
    """The stage-cut library's "all" cut is the production kernel: w, wn
    and rnorm equal the production library's gls_solve_launch's bit for
    bit."""
    inp, sweeps, prod = cut_runs(neumann, rounds)
    cut = _solve(emu_stages, inp, sweeps=sweeps, rounds=rounds, stop="all")
    for a, b in zip(cut, prod):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rounds", [2, 1])
@pytest.mark.parametrize("neumann", [False, True])
def test_gls_solve_stage_checksums_match_plain_version(emu_stages, cut_runs,
                                                       neumann, rounds):
    """Each stage cut of the kernel's ``rounds`` instance (the route's
    sweeps) writes zero w and wn and, as rnorm, the same sum as the plain
    version's intermediate (cholqr2_solve(..., stop=...)), so each cut
    stops where its name says: held as tools/kernel_stages.py holds the
    cuts on the card (cut_errors: the float32 cuts to 1e-5 of the same
    sum of their magnitude, chol1 also to 10 times the plain version's
    own distance from the float64 factor, the float64 sums of the inputs
    and of A to 1e-12, y after the sweeps to 1e-10; the interior class's
    sweeps cut is left out for time).  The invalid node's checksum is 0
    in both."""
    inp, sweeps, (_, _, rn) = cut_runs(neumann, rounds)
    assert (rn[:-1] <= RNORM_TOL).all()
    stops = [s for s in gs.stages(rounds)[:-1] if neumann or s != "sweeps"]
    errors = kernel_stages.cut_errors(
        inp, rounds, sweeps, stops=stops,
        run=lambda stop, at: _solve(emu_stages, inp, sweeps=at,
                                    rounds=rounds, stop=stop))
    assert list(errors) == stops
    for stop, e in errors.items():
        assert e["nodes"] == 1 and e["max_err"] <= e["tol"], (stop, e)
        assert e.get("sweeps", sweeps) == sweeps, (stop, e)


def test_gls_solve_stage_rejects_cuts_it_does_not_have(emu, emu_stages,
                                                       cut_runs):
    """The one-round instance has no cut inside round two, and no cut lies
    past "all": the entry refuses them (cudaErrorInvalidValue) and the
    wrapper raises before any launch; on a CPU tensor the wrapper runs
    the plain version and counts no launch.  The production library has
    no stage entry, the stage-cut library no production entry."""
    assert not hasattr(emu["gls_solve"], "gls_solve_stage_launch")
    assert not hasattr(emu_stages, "gls_solve_launch")
    inp, _, _ = cut_runs(False, 2)
    lib = emu_stages
    B, E, _ = inp["dk"].shape
    F = inp["l1"].shape[1]
    out = [torch.empty((B, E), dtype=torch.float64),
           torch.empty(B, dtype=torch.float64),
           torch.empty(B, dtype=torch.float64)]
    args = [inp[k] for k in ("dk", "l1", "l2", "t1m", "tt", "lb", "nm",
                             "pair", "ks", "cv", "fv", "isneu", "valid")]
    for rounds, stop in ((1, gs.STAGES.index("q")), (1, gs.STAGES.index(
            "chol2")), (2, len(gs.STAGES)), (2, -1)):
        assert lib.gls_solve_stage_launch(
            *[_ptr(a) for a in args + out], None, 0, B, E, F, 0, 3, rounds,
            stop, 1e-12, 1.5e-5, None) == 1
    assert gs.stages(1) == ("floor", "rows", "gram1", "chol1", "sweeps",
                            "all")
    for stop, rounds in (("q", 1), ("gram2", 1), ("bogus", 2)):
        with pytest.raises(ValueError, match="no stage"):
            gs.gls_solve_stage(stop, **inp, rounds=rounds)
    before = gs.gls_solve_stage.launches
    w, wn, rn = gs.gls_solve_stage("rows", **inp)
    assert gs.gls_solve_stage.launches == before
    assert not w.any() and rn[:-1].all()


@pytest.mark.parametrize("queued", [True, False], ids=["queued", "event-first"])
def test_best_ms_queues_each_launch_behind_device_work(monkeypatch, queued):
    """kernel_stages.best_ms on a card faked by CUDA events: a warm-up
    call, then REPS timed calls, each start event recorded after
    QUEUE_CYCLES of torch.cuda._sleep (``queued``; none without), so that
    the host's time to submit the launch stays out of the window; the
    result is the least window."""
    calls, clock = [], [0.0]

    class Event:
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self):
            calls.append("record")
            self.t = clock[0]

        def elapsed_time(self, end):
            return end.t - self.t

    def sleep(cycles):
        calls.append(("sleep", cycles))

    durations = iter([9.0, 3.0, 2.0, 4.0, 2.5, 5.0])

    def launch():
        calls.append("launch")
        clock[0] += next(durations)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "_sleep", sleep)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    assert kernel_stages.best_ms(launch, queued=queued) == 2.0
    rep = ([("sleep", kernel_stages.QUEUE_CYCLES)] if queued else []) + [
        "record", "launch", "record"]
    assert calls == ["launch"] + rep * kernel_stages.REPS
