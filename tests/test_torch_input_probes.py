"""Kernel 1's input-stream probes (ninpol_tpu_torch/ops/input_probes.py,
tools/input_probes.py) on the CPU: each plain version against the bodies
of tools/r5_layout_probe.py and r5_overlap_probe.py, re-written in
interpret-mode pallas_calls at their own shapes (NT = 128, F = 36, E =
24), and against float64 NumPy on the route's own chunks; the wrappers on
CPU tensors and their raises; the emulator's mbarrier and cp.async.bulk;
each CUDA kernel instance through the emulator of tests/utils/cuda_emu
against its plain version; the tool's error, verdict and bound paths;
chip_smoke.py's kernels-line entries and the sites they name."""
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

import ninpol_tpu  # noqa: F401  (x64)
from ninpol_tpu_torch.ops import input_probes as ip
from ninpol_tpu_torch.tools import SITES, input_probes as tool, site_of
from tests.test_torch_gls_solve import _port_chunk
from tests.utils import cuda_emu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the record sums: another order of the same float64 sums, per node over
# the sum of the entries' magnitudes; float32 results (the dummy work, and
# the TPU bodies' float32 sums) over their own magnitudes (tool.TOL_SUM,
# tool.TOL_WORK)
TOL_SUM = tool.TOL_SUM
TOL_WORK = tool.TOL_WORK
NT, F, E = 128, 36, 24            # the TPU probes' shapes
R = 28 * F                        # r5_layout_probe.py's rows a tile
ITERS = 60                        # r5_overlap_probe.py's dummy work


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's default of one
    thread per core would oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _f64_record(values):
    """(B, n) float64 values as a record of one float64 region (zero-padded
    to 16 bytes)."""
    B, n = values.shape
    padded = np.zeros((B, n + n % 2))
    padded[:, :n] = values
    data = _t(padded).view(torch.uint8)
    return ip.Record(data.contiguous(), (data.shape[1], 0, 0))


def _node_err(got, ref, scale):
    got, ref, scale = (np.asarray(a, np.float64) for a in (got, ref, scale))
    d = np.abs(got - ref)
    if d.ndim > 1:
        d = d.reshape(len(d), -1).max(1)
    return float((d / scale).max())


def _chunk(B, E_, F_, wneu, seed=0):
    """Synthetic kernel-1 inputs of one class: standard normal geometry,
    cell indices up to 2e6 (-1 for a boundary face's second cell), random
    masks."""
    rng = np.random.default_rng(seed)
    f = lambda *s: _t(rng.standard_normal(s))   # noqa: E731
    pair = rng.integers(0, 2_000_000, (B, F_, 2)).astype(np.int32)
    pair[rng.random((B, F_)) < 0.3, 1] = -1
    return dict(
        dk=f(B, E_, 3), l1=f(B, F_, 3), l2=f(B, F_, 3), t1m=f(B, F_, 3),
        tt=f(B, F_, 3), lb=f(B, F_, 3) if wneu else None,
        nm=f(B, F_) if wneu else None, pair=_t(pair),
        ks=_t(rng.integers(0, 2_000_000, (B, E_)).astype(np.int32)),
        cv=_t(rng.random((B, E_)) < 0.8), fv=_t(rng.random((B, F_)) < 0.8),
        isneu=_t(rng.random(B) < 0.5), valid=_t(rng.random(B) < 0.9))


# ---------------------------------------------------------------------------
# plain versions against the TPU probes' bodies
# ---------------------------------------------------------------------------
def _sp(*dims):
    return pl.BlockSpec((1,) + dims, lambda i: (i,) + (i * 0,) * len(dims),
                        memory_space=pltpu.VMEM)


@pytest.fixture(scope="module")
def layout_bodies():
    """r5_layout_probe.py's four bodies (:60 A, :72 B, :85 C, :105 D) in
    interpret-mode pallas_calls at their own block shapes, on float64
    inputs (the record's type; the bodies are the probe's): A, B and C at G
    = 2 tiles, D at its eight tiles a step (G = 8, one step)."""
    rng = np.random.default_rng(0)
    f64 = jnp.float64
    G = 2
    xa = rng.standard_normal((G, 28, F, NT))
    xb = rng.standard_normal((G, R, NT))
    xc = rng.standard_normal((G, R // 4, 4 * NT))
    xd = rng.standard_normal((8, R, NT))

    def body_a(x, o):
        o[0] = jnp.sum(x[0], axis=(0, 1))[None, :]

    def body_b(x, o):
        o[0] = jnp.sum(x[0], axis=0)[None, :]

    def body_c(x, o):
        o[0] = jnp.sum(x[0], axis=0)[None, :NT]

    def body_d(x, o):
        for t in range(8):
            o[t] = jnp.sum(x[t], axis=0)[None, :]

    def call(body, x, in_spec, out_spec, steps):
        return np.asarray(pl.pallas_call(
            body, grid=(steps,), in_specs=[in_spec], out_specs=out_spec,
            out_shape=jax.ShapeDtypeStruct((len(x), 1, NT), f64),
            interpret=True)(jnp.asarray(x)))[:, 0, :]

    spd = pl.BlockSpec((8, R, NT), lambda i: (i, i * 0, i * 0),
                       memory_space=pltpu.VMEM)
    spo = pl.BlockSpec((8, 1, NT), lambda i: (i, i * 0, i * 0),
                       memory_space=pltpu.VMEM)
    out = {"A": (xa, call(body_a, xa, _sp(28, F, NT), _sp(1, NT), G)),
           "B": (xb, call(body_b, xb, _sp(R, NT), _sp(1, NT), G)),
           "C": (xc, call(body_c, xc, _sp(R // 4, 4 * NT), _sp(1, NT), G)),
           "D": (xd, call(body_d, xd, spd, spo, 1))}
    return out


def _lane_records(x):
    """Each lane of each tile as a node: (tiles x lanes, the tile's entries
    of that lane)."""
    G = x.shape[0]
    return np.moveaxis(x.reshape(G, -1, x.shape[-1]), 2, 1).reshape(
        -1, x[0].size // x.shape[-1])


@pytest.mark.parametrize("body", ["A", "B", "C", "D"])
def test_input_sum_matches_the_layout_bodies(layout_bodies, body):
    """input_sum's plain version, node-major and node-minor, on each lane's
    entries as a node's record, against the probe body's per-lane sum
    (C: on the lanes it keeps, whose records are its columns [:NT])."""
    x, got_tpu = layout_bodies[body]
    if body == "C":
        recs = np.moveaxis(x[:, :, :NT], 2, 1).reshape(-1, R // 4)
    else:
        recs = _lane_records(x)
    rec = _f64_record(recs)
    scale = np.abs(recs).sum(1)
    for r in (rec, rec.to_minor()):
        got = ip.input_sum_reference(r).numpy()
        assert _node_err(got, got_tpu.reshape(-1), scale) < TOL_SUM


@pytest.fixture(scope="module")
def overlap_bodies():
    """r5_overlap_probe.py's three bodies (:100, A trivial, B dummy-indep,
    C dummy-dep) as written (float32), in an interpret-mode pallas_call of
    one tile of the production input block set (9 inputs, E = 24, F = 36,
    Fp = 40); the values its ``touch`` reads, each lane's first row of
    each input."""
    Fp, Ep = 40, 24
    f32 = jnp.float32
    rng = np.random.default_rng(1)
    shapes = [(1, 6, NT), (1, 6 * Ep, NT), (1, 28 * Fp, NT), (1, 2 * Fp, NT),
              (1, E, NT), (1, E, NT), (1, F, NT), (1, 1, NT), (1, 1, NT)]
    ins = [rng.standard_normal(s).astype(np.float32) for s in shapes]

    def touch(refs):
        return (refs[2][0][:1] + refs[0][0][:1] + refs[1][0][:1]
                + refs[3][0][:1] + refs[4][0][:1] + refs[5][0][:1]
                + refs[6][0][:1] + refs[7][0] + refs[8][0])

    def dummy_work(seed, iters=ITERS):
        acc = jnp.broadcast_to(seed, (E, 128, NT)) * f32(1e-6)
        x = acc
        for _ in range(iters):
            x = x * f32(0.999) + acc
        return jnp.sum(x, axis=1)

    def body_a(*refs):
        w, r = refs[-2], refs[-1]
        red = touch(refs[:-2])
        w[0] = jnp.broadcast_to(red, (E, NT))
        r[0] = red

    def body_b(*refs):
        w, r = refs[-2], refs[-1]
        red = touch(refs[:-2])
        w[0] = dummy_work(jnp.ones((1, 1, NT), f32))
        r[0] = red

    def body_c(*refs):
        w, r = refs[-2], refs[-1]
        red = touch(refs[:-2])
        w[0] = dummy_work(red[None, :1, :])
        r[0] = red

    out = {}
    for name, body in (("trivial", body_a), ("indep", body_b),
                       ("dep", body_c)):
        w, r = pl.pallas_call(
            body, grid=(1,), in_specs=[_sp(*s[1:]) for s in shapes],
            out_specs=[_sp(E, NT), _sp(1, NT)],
            out_shape=[jax.ShapeDtypeStruct((1, E, NT), f32),
                       jax.ShapeDtypeStruct((1, 1, NT), f32)],
            interpret=True)(*[jnp.asarray(x) for x in ins])
        out[name] = (np.asarray(w)[0].T, np.asarray(r)[0, 0])
    touched = np.stack([x[0, 0] for x in ins], axis=1).astype(np.float64)
    return touched, out


@pytest.mark.parametrize("body", ["trivial", "indep", "dep"])
def test_overlap_matches_the_probe_bodies(overlap_bodies, body):
    """overlap_probe's plain version on records of the values ``touch``
    reads, against the probe body: r and the trivial w (float32 sums there)
    within TOL_WORK of the values' magnitudes, the dummy work within
    TOL_WORK of Σ_k |x|."""
    touched, out = overlap_bodies
    w_tpu, r_tpu = out[body]
    rec = _f64_record(touched)
    w, r = ip.overlap_probe_reference(rec, body, E, ITERS, 1.0)
    scale = np.abs(touched).sum(1)
    assert _node_err(r.numpy(), r_tpu, scale) < TOL_WORK
    if body == "trivial":
        assert _node_err(w.numpy(), w_tpu, scale) < TOL_WORK
        return
    seed = r.float() if body == "dep" else torch.ones(NT)
    wscale = ip.dummy_work_reference(seed, ITERS, E)[1].numpy()
    assert _node_err(w.numpy(), w_tpu, wscale) < TOL_WORK


# ---------------------------------------------------------------------------
# plain versions against float64 on the route's chunks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def route_chunks():
    """Both classes of tetra_mesh(3) as the default route gathers them."""
    return {neu: _port_chunk(neumann=neu) for neu in (False, True)}


@pytest.mark.parametrize("neumann", [False, True], ids=["interior", "neumann"])
def test_plain_versions_match_float64(route_chunks, neumann):
    """The packed record holds the thirteen inputs' bytes in 16-byte fields
    with zero padding; its sum, node-major and node-minor, and the natural
    sum equal NumPy's float64 sum of every entry (integers exact) within
    TOL_SUM; the dummy work's float32 recurrence is within TOL_WORK of
    float64."""
    inp = route_chunks[neumann]
    B = inp["dk"].shape[0]
    rec = ip.pack(inp)
    assert all(r % 16 == 0 for r in rec.regions)
    assert rec.data.shape == (B, rec.stride) and rec.stride % 16 == 0
    f64 = [inp[k].numpy().reshape(B, -1) for k in ip.FIELDS
           if inp[k] is not None and inp[k].dtype == torch.float64]
    ints = [inp[k].numpy().reshape(B, -1).astype(np.int64) for k in ip.FIELDS
            if inp[k] is not None and inp[k].dtype != torch.float64]
    want = sum(x.sum(1) for x in f64) + sum(x.sum(1) for x in ints)
    scale = (sum(np.abs(x).sum(1) for x in f64)
             + sum(np.abs(x).sum(1) for x in ints))
    for x in (inp, rec, rec.to_minor()):
        assert _node_err(ip.input_sum_reference(x).numpy(), want,
                         scale) < TOL_SUM
    assert np.allclose(ip.input_sum_reference(rec, absolute=True).numpy(),
                       scale, rtol=1e-14)
    # the dk field is the record's first bytes, then zeros to 16
    raw = rec.data.numpy()
    dk = inp["dk"].numpy().reshape(B, -1)
    assert np.array_equal(raw[:, :dk.nbytes // B].view(np.float64), dk)
    assert rec.to_minor().to_major().data.equal(rec.data)
    # the dummy work against float64
    seed = torch.linspace(0.5, 3.0, B)
    w, wscale = ip.dummy_work_reference(seed, ITERS, 7)
    x = seed.double().numpy()[:, None] * np.float32(1e-6)
    acc = x.copy()
    for _ in range(ITERS):
        x = x * 0.999 + acc
    assert _node_err(w.numpy(), 128 * x, wscale.numpy()) < TOL_WORK


def test_wrappers_run_plain_versions_on_cpu(route_chunks):
    """On CPU tensors each wrapper is its plain version and launches
    nothing; arguments the kernels do not take raise."""
    inp = route_chunks[True]
    rec = ip.pack(inp)
    before = [w.launches for w in ip.KERNELS]
    for lay in ip.NATURAL:
        assert torch.equal(ip.input_sum(inp, lay),
                           ip.input_sum_reference(inp))
    for lay in ("packed", "wide", "bulk", "multi"):
        assert torch.equal(ip.input_sum(rec, lay, smem_bytes=4096),
                           ip.input_sum_reference(rec))
    assert torch.equal(ip.input_sum(rec.to_minor(), "minor"),
                       ip.input_sum_reference(rec))
    for body in ip.BODIES:
        w, r = ip.overlap_probe(rec, body, "pipelined", 12, 3, 2.0)
        wr, rr = ip.overlap_probe_reference(rec, body, 12, 3, 2.0)
        assert torch.equal(w, wr) and torch.equal(r, rr)
        assert w.shape == (rec.nodes, 12) and w.dtype == torch.float32
    assert not ip.overlap_probe(rec, "compute", "block", 4)[1].any()
    assert [w.launches for w in ip.KERNELS] == before
    skewed = ip.Record(rec.data[:, :-8].contiguous(),
                       (rec.regions[0], rec.regions[1], rec.regions[2] - 8))
    for bad in (lambda: ip.input_sum(rec, "diagonal"),
                lambda: ip.input_sum(rec, "natural"),
                lambda: ip.input_sum(rec, "prologue"),
                lambda: ip.input_sum(rec, "wide", blocks=2),
                lambda: ip.input_sum(rec, "packed", blocks=0),
                lambda: ip.input_sum(inp, "prologue", blocks=2),
                lambda: ip.input_sum(inp, "packed"),
                lambda: ip.input_sum(rec, "minor"),
                lambda: ip.input_sum(rec.to_minor(), "wide"),
                lambda: ip.input_sum(skewed, "packed"),
                lambda: ip.input_sum(rec, "packed", smem_bytes=-1),
                lambda: ip.input_sum(dict(inp, ks=inp["ks"].long()),
                                     "natural"),
                lambda: ip.input_sum({k: inp[k] for k in ip.FIELDS[:-1]},
                                     "natural"),
                lambda: ip.overlap_probe(rec, "lazy", "block", E),
                lambda: ip.overlap_probe(rec, "dep", "eager", E),
                lambda: ip.overlap_probe(rec, "dep", "block", 0),
                lambda: ip.overlap_probe(rec, "dep", "block", 33),
                lambda: ip.overlap_probe(rec, "dep", "block", E, iters=-1),
                lambda: ip.overlap_probe(rec, "dep", "pipelined", E,
                                         blocks=0),
                lambda: ip.overlap_probe(rec.to_minor(), "dep", "block", E)):
        with pytest.raises(ValueError):
            bad()


# ---------------------------------------------------------------------------
# the emulator's mbarrier and cp.async.bulk
# ---------------------------------------------------------------------------
_PRIMITIVES = r"""
#include <cuda_runtime.h>

// a sequence of waits on one mbarrier, each result in seen[]
extern "C" int mbarrier_sequence(int* seen) {
  uint64_t bar;
  unsigned char src[64], dst[64];
  for (int i = 0; i < 64; ++i) src[i] = (unsigned char)(3 * i + 1);
  int n = 0;
  emu_mbarrier_init(&bar, 2);
  seen[n++] = emu_mbarrier_try_wait_parity(&bar, 0);   // 0: two arrivals pending
  emu_mbarrier_arrive(&bar);
  seen[n++] = emu_mbarrier_try_wait_parity(&bar, 0);   // 0: one pending
  emu_mbarrier_arrive(&bar);
  seen[n++] = emu_mbarrier_try_wait_parity(&bar, 0);   // 1: phase 0 complete
  seen[n++] = emu_mbarrier_try_wait_parity(&bar, 1);   // 0: phase 1 under way
  emu_mbarrier_arrive_expect_tx(&bar, 64);
  seen[n++] = emu_mbarrier_try_wait_parity(&bar, 1);   // 0: an arrival and 64 bytes pending
  emu_mbarrier_arrive(&bar);
  seen[n++] = emu_mbarrier_try_wait_parity(&bar, 1);   // 0: 64 bytes pending
  emu_cp_async_bulk(dst, src, 64, &bar);
  seen[n++] = emu_mbarrier_try_wait_parity(&bar, 1);   // 1: phase 1 complete
  seen[n++] = emu_mbarrier_try_wait_parity(&bar, 0);   // 0: phase 2 under way
  int same = 1;
  for (int i = 0; i < 64; ++i) same &= dst[i] == src[i];
  seen[n++] = same;                                    // 1: the bytes arrived
  return n;
}

// one block: thread 0 copies ``bytes`` into shared memory; every thread
// then reads the barrier and a byte of the copy
__global__ void bulk_kernel(const unsigned char* src, int* out, int bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar[1];
  if (threadIdx.x == 0) {
    emu_mbarrier_init(bar, 1);
    emu_mbarrier_arrive_expect_tx(bar, bytes);
    emu_cp_async_bulk(smem, src, bytes, bar);
  }
  __syncthreads();
  const bool done = emu_mbarrier_try_wait_parity(bar, 0) && !emu_mbarrier_try_wait_parity(bar, 1);
  out[threadIdx.x] = done ? smem[threadIdx.x % bytes] : -1;
}

extern "C" int bulk_block(const unsigned char* src, int* out, int bytes) {
  bulk_kernel<<<1, 64, bytes, nullptr>>>(src, out, bytes);
  return 0;
}
"""


@pytest.fixture(scope="module")
def primitives(tmp_path_factory):
    if cuda_emu.gxx() is None:
        pytest.skip("needs g++ to build the emulated kernels")

    def bind(lib):
        vp = ctypes.c_void_p
        lib.mbarrier_sequence.argtypes = [vp]
        lib.bulk_block.argtypes = [vp, vp, ctypes.c_int]
    return cuda_emu.build_text(_PRIMITIVES, "primitives",
                               str(tmp_path_factory.mktemp("prim")), bind)


def test_emulated_mbarrier_phases(primitives):
    """mbarrier init, arrive, expect_tx and try_wait.parity: a phase
    completes when its arrivals and its transaction bytes are all in, and
    the next phase starts; cp.async.bulk copies and completes its bytes."""
    seen = (ctypes.c_int * 16)()
    n = primitives.mbarrier_sequence(seen)
    assert list(seen[:n]) == [0, 0, 1, 0, 0, 0, 1, 0, 1]


def test_emulated_bulk_copy_in_a_block(primitives):
    """cp.async.bulk issued by one thread of a block: every thread (two
    warps, two OS threads) sees the barrier's phase complete and the
    copied bytes in shared memory."""
    src = torch.arange(48, dtype=torch.uint8) * 5
    out = torch.zeros(64, dtype=torch.int32)
    primitives.bulk_block(src.data_ptr(), out.data_ptr(), 48)
    assert torch.equal(out, src[torch.arange(64) % 48].int())


# ---------------------------------------------------------------------------
# the CUDA kernels, emulated on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    if cuda_emu.gxx() is None:
        pytest.skip("needs g++ to build the emulated kernels")
    return cuda_emu.build("input_probes", str(tmp_path_factory.mktemp("emu")),
                          ip._bind)


def _emulate(monkeypatch, lib):
    """The wrappers launching the emulated kernels on CPU tensors."""
    monkeypatch.setattr(ip.library, "lib", lib)
    monkeypatch.setattr(ip, "on_card", lambda x, name: True)
    monkeypatch.setattr(ip, "stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())


@pytest.fixture
def emu(emu_lib, monkeypatch):
    _emulate(monkeypatch, emu_lib)
    return emu_lib


# 9 nodes of a small class, with and without Neumann rows (multi's 8 nodes
# a block and minor's 128 leave a tail), and one node of (24, 36)
CLASSES = [(9, 4, 6, True), (9, 4, 6, False), (1, 24, 36, False)]


@pytest.mark.parametrize("B,E_,F_,wneu", CLASSES,
                         ids=[f"{B}x({e},{f}){'n' if w else ''}"
                              for B, e, f, w in CLASSES])
@pytest.mark.parametrize("layout", ip.LAYOUTS)
def test_input_sum_kernel_matches_plain(emu, layout, B, E_, F_, wneu):
    """Each input_sum instance against its plain version within TOL_SUM of
    the record's magnitudes; one launch counted for its instance; a shared
    memory request past what it needs changes nothing."""
    inp = _chunk(B, E_, F_, wneu)
    rec = ip.pack(inp)
    x = (inp if layout in ip.NATURAL else
         rec.to_minor() if layout == "minor" else rec)
    name = ip.instance("input_sum", layout=layout)
    before = ip.input_sum.launches_by[name]
    got = ip.input_sum(x, layout, smem_bytes=5000 if layout == "bulk" else 0)
    assert ip.input_sum.launches_by[name] == before + 1
    scale = ip.input_sum_reference(inp, absolute=True)
    assert _node_err(got, ip.input_sum_reference(inp), scale) <= TOL_SUM


def _shifted(inp):
    """The same inputs, each tensor 8 bytes past a 16-byte boundary (a
    view into a larger buffer), so the natural body's covering spans are
    clipped at every tensor's start."""
    out = {}
    for k, v in inp.items():
        if v is None:
            out[k] = None
            continue
        raw = (v.to(torch.uint8) if v.dtype == torch.bool
               else v.contiguous().view(torch.uint8)).reshape(-1)
        buf = torch.zeros(raw.numel() + 32, dtype=torch.uint8)
        at = (8 - buf.data_ptr()) % 16 + 16
        view = buf[at:at + raw.numel()]
        view.copy_(raw)
        out[k] = (view.bool() if v.dtype == torch.bool
                  else view.view(v.dtype)).view(v.shape)
    return out


# the redesigned bodies' edges: more nodes than persistent warps (2
# blocks: each warp walks 2-3 nodes, so its buffers' phases flip), also
# where every natural span is whole 16-byte words (its aligned instance,
# as at the tet classes); odd E
# and F (spans not 16-byte aligned a node), with and without Neumann rows,
# whose last node ends inside a 16-byte word (the span clipped, its tail
# by plain loads); tensors 8 bytes off a 16-byte boundary; a record of two
# 576-word chunks a node (packed); (B, E, F, Neumann rows, shifted)
EDGES = {"walk": (40, 3, 5, True, False), "walk-whole": (40, 4, 6, True, False),
         "odd": (37, 5, 7, False, False),
         "odd-neumann": (21, 3, 5, True, False),
         "shifted": (13, 5, 7, True, True),
         "two-chunks": (5, 30, 40, True, False)}


@pytest.mark.parametrize("edge", list(EDGES))
@pytest.mark.parametrize("layout", ["natural", "packed", "minor"])
def test_redesigned_bodies_edge_cases(emu, layout, edge):
    """Each redesigned input_sum body against its plain version within
    TOL_SUM at its edges (EDGES), on 2 persistent blocks where it is
    persistent; one launch counted."""
    B, E_, F_, wneu, shifted = EDGES[edge]
    inp = _chunk(B, E_, F_, wneu, seed=5)
    if shifted:
        inp = _shifted(inp)
        assert inp["dk"].data_ptr() % 16 == 8
    rec = ip.pack(inp)
    x = (inp if layout == "natural" else
         rec.to_minor() if layout == "minor" else rec)
    name = ip.instance("input_sum", layout=layout)
    before = ip.input_sum.launches_by[name]
    got = ip.input_sum(x, layout,
                       blocks=2 if layout in ip.PERSISTENT else None)
    assert ip.input_sum.launches_by[name] == before + 1
    scale = ip.input_sum_reference(inp, absolute=True)
    assert _node_err(got, ip.input_sum_reference(inp), scale) <= TOL_SUM


@pytest.mark.parametrize("layout", ["natural", "packed", "minor"])
def test_redesigned_bodies_past_their_shared_memory(emu, layout):
    """A shared memory request past what a redesigned body needs (kernel
    1's, then the most a block may have) holds fewer blocks an SM, so the
    persistent bodies run another grid: no bit of the sums changes."""
    inp = _chunk(45, 5, 7, True, seed=6)
    rec = ip.pack(inp)
    x = (inp if layout == "natural" else
         rec.to_minor() if layout == "minor" else rec)
    own = ip.input_sum(x, layout)
    for request in (105824, 200000):
        assert torch.equal(ip.input_sum(x, layout, smem_bytes=request), own)
    occ = [ip.occupancy("input_sum", rec.stride, 5, request, 7, True,
                        layout=layout)["blocks_per_sm"]
           for request in (0, 200000)]
    assert occ[1] == 1 and occ[0] >= 2


# block: 9 nodes; pipelined: 3 nodes over 2 persistent blocks (the first
# walks nodes 0 and 2 and fills both buffers); both on one (24, 36) node
OVERLAP_CASES = [(s, *c) for s in ip.SCHEDULES
                 for c in ((9 if s == "block" else 3, 4, 6, True),
                           (1, 24, 36, False))]


@pytest.mark.parametrize("schedule,B,E_,F_,wneu", OVERLAP_CASES,
                         ids=[f"{s}-{B}x({e},{f})"
                              for s, B, e, f, _ in OVERLAP_CASES])
@pytest.mark.parametrize("body", ip.BODIES)
def test_overlap_kernel_matches_plain(emu, body, schedule, B, E_, F_, wneu):
    """Each overlap_probe instance against its plain version at 3 rounds
    from seed 2: r within TOL_SUM of the record's magnitudes (0 for
    compute), w within TOL_WORK of its own; one launch counted."""
    rec = ip.pack(_chunk(B, E_, F_, wneu, seed=3))
    name = ip.instance("overlap_probe", body=body, schedule=schedule)
    before = ip.overlap_probe.launches_by[name]
    blocks = 2 if schedule == "pipelined" and B == 3 else None
    w, r = ip.overlap_probe(rec, body, schedule, E_, iters=3, seed=2.0,
                            blocks=blocks)
    assert ip.overlap_probe.launches_by[name] == before + 1
    w_ref, r_ref = ip.overlap_probe_reference(rec, body, E_, 3, 2.0)
    scale = ip.input_sum_reference(rec, absolute=True)
    assert _node_err(r, r_ref, scale) <= TOL_SUM
    if body == "compute":
        assert not r.any()
    if body == "trivial":
        wscale = scale
    else:
        seed = r_ref.float() if body == "dep" else torch.full((B,), 2.0)
        wscale = ip.dummy_work_reference(seed, 3, E_)[1]
    assert _node_err(w, w_ref, wscale) <= TOL_WORK


def test_tool_errors_on_route_chunks(emu_lib, monkeypatch, route_chunks):
    """The tool's inputs and error path on the route's own chunks
    (tetra_mesh(3), three nodes a class): ``prepare`` packs both classes
    (plain versions: CPU tensors); then every instance of CONFIGS,
    emulated, is held to its plain version by ``probe_errors``, a launch
    counted for each."""
    chunks = []
    for neumann, inp in route_chunks.items():
        inp = {k: None if v is None else v[:3].contiguous()
               for k, v in inp.items()}
        c = {"E": inp["dk"].shape[1], "F": inp["l1"].shape[1],
             "with_neumann": neumann}
        chunks.append((c, inp, None))
    prepared = tool.prepare(chunks)
    assert [(h["E"], h["F"], h["chunk"]) for h, _ in prepared] == [
        (24, 36, 3), (12, 24, 3)]
    for head, t in prepared:
        assert head["natural_bytes"] <= head["record_bytes"]
        assert t["minor"].data.shape == (head["stride"] // 8, 3)
        head.update(k1_request=95648, iters_cal=2)
    _emulate(monkeypatch, emu_lib)
    tool.reset_counts()
    errors = tool.probe_errors(prepared)
    assert ip.input_sum.launches == 2 * (len(ip.LAYOUTS)
                                         + len(tool.K1_LAYOUTS))
    assert ip.overlap_probe.launches == 2 * 32
    for errs in errors:
        assert set(errs) == {tool.label(k, w) for k, w in tool.CONFIGS}
        for name, e in errs.items():
            assert e["max_err"] <= e["tol"], (name, e)
            assert e.get("r_err", 0.0) <= e.get("r_tol", 0.0), (name, e)
            assert e["nodes"] == 3


# ---------------------------------------------------------------------------
# verdicts, bounds, the kernels line, the sites
# ---------------------------------------------------------------------------
LAYOUT_MS = {"natural": 0.060, "packed": 0.058, "wide": 0.088,
             "bulk": 0.069, "multi": 0.067, "minor": 0.056,
             "prologue": 0.108}
# at kernel 1's shared memory
K1_MS = {"natural": 0.075, "packed": 0.062, "minor": 0.064,
         "prologue": 0.343}


def _row(overlap_ms, k1_blocks=2, k1_ms=K1_MS):
    """A table row of made-up times: the layouts' LAYOUT_MS, K1_LAYOUTS at
    kernel 1's shared memory ``k1_ms``; ``overlap_ms[(schedule, smem)]``
    the (trivial, indep, dep, compute) ms at both round counts."""
    kernels = {}
    for kernel, kw in tool.CONFIGS:
        if kernel == "input_sum":
            ms = (k1_ms if kw["smem"] == "k1" else LAYOUT_MS)[kw["layout"]]
        else:
            ms = dict(zip(("trivial", "indep", "dep", "compute"),
                          overlap_ms[kw["schedule"], kw["smem"]]))[kw["body"]]
        kernels[tool.label(kernel, kw)] = {
            "kernel": kernel, **kw, "ms": ms, "plain_ms": 0.3,
            "bound_ms": 0.044, "bound_by": "bytes",
            "library_ms": None if kernel == "overlap_probe" else 0.064,
            "max_abs_err": 1e-9, "max_err": 1e-16, "tol": 1e-12,
            "occupancy": {"blocks_per_sm": 2 if kw["smem"] == "k1" else 8}}
    return {"E": 24, "F": 36, "with_neumann": False, "chunk": 32768,
            "natural_bytes": 4478 * 32768, "record_bytes": 4528 * 32768,
            "floor_ms": 0.618, "k1_blocks_per_sm": k1_blocks,
            "kernels": kernels}


OVERLAP_MS = {("block", "own"): (0.10, 0.27, 0.27, 0.26),      # excess 0.1
              ("block", "k1"): (0.24, 0.47, 0.50, 0.28),       # 0.79
              ("pipelined", "own"): (0.08, 0.31, 0.31, 0.27),  # 0.5
              ("pipelined", "k1"): (0.12, 0.30, 0.30, 0.28)}   # 0.17


def test_verdicts_follow_the_tpu_rules():
    """r5_layout_probe.py's and r5_overlap_probe.py's questions on made-up
    times: the fastest layout, natural's ratios, the prologue's share of
    the floor cut; the floor verdict (the redesigned natural at kernel 1's
    shared memory against the prologue and the packed record's fastest
    body, and whether the pack step's pass pays for itself); per schedule
    and shared memory the excess over max(trivial, compute) in units of
    the smaller, its verdict by MARGIN, dep against indep, and the
    pipelined schedule against the block one at kernel 1's shared memory;
    kernel 1's blocks held."""
    v = tool.verdicts(_row(OVERLAP_MS))
    lay = v["layout"]
    assert lay["fastest"] == "minor"
    assert lay["k1_ms"] == K1_MS
    assert lay["natural_over_packed"] == pytest.approx(0.060 / 0.058)
    assert lay["natural_over_wide_bulk"] == pytest.approx(0.060 / 0.069)
    assert lay["prologue_share_of_floor"] == pytest.approx(0.108 / 0.618)
    assert lay["prologue_k1_share_of_floor"] == pytest.approx(0.343 / 0.618)
    assert lay["rest_ms"] == pytest.approx(0.618 - 0.343)
    fl = v["floor"]
    assert fl["natural_k1_over_prologue_k1"] == pytest.approx(0.075 / 0.343)
    assert fl["packed_best"] == "packed,k1"
    assert fl["natural_k1_over_packed_best"] == pytest.approx(0.075 / 0.062)
    assert fl["record_saves_ms"] == pytest.approx(0.075 - 0.062)
    # the pack pass reads the thirteen tensors and writes the record
    assert fl["pack_pass_bound_ms"] == pytest.approx(
        (4478 + 4528) * 32768 / 3.35e9)
    assert not fl["pack_step_pays"]
    slow = tool.verdicts(_row(OVERLAP_MS, k1_ms=dict(K1_MS, natural=0.3)))
    assert slow["floor"]["pack_step_pays"]
    assert slow["floor"]["record_saves_ms"] == pytest.approx(0.3 - 0.062)
    o = v["overlap"]
    assert o["block,own,60"]["excess"] == pytest.approx(0.1)
    assert o["block,own,60"]["verdict"] == "overlapped"
    assert o["block,k1,60"]["verdict"] == "serial"
    assert o["pipelined,own,cal"]["verdict"] == "partial"
    assert o["pipelined,k1,60"]["verdict"] == "overlapped"
    assert o["block,k1,60"]["dep_costs_more"]            # 0.50 > 1.05 x 0.47
    assert not o["block,own,60"]["dep_costs_more"]
    assert all(x["indep_not_faster"] for x in o.values())
    assert v["pipelined_overlaps_where_block_k1_does_not"] == {
        "60": {"own": False, "k1": True}, "cal": {"own": False, "k1": True}}
    assert v["k1_blocks_held"]
    assert not tool.verdicts(_row(OVERLAP_MS, k1_blocks=3))["k1_blocks_held"]


def test_failed_flags_errors_and_folded_work():
    """``failed`` names an instance past its tolerance (w or r) and an
    indep faster than compute alone at the TPU's rounds; the calibrated
    rounds are not held to that."""
    row = _row(OVERLAP_MS)
    row["verdicts"] = tool.verdicts(row)
    assert tool.failed([row]) == []
    folded = dict(OVERLAP_MS)
    folded["block", "own"] = (0.10, 0.20, 0.27, 0.26)
    row = _row(folded)
    name = tool.label("overlap_probe", {"body": "dep", "schedule": "block",
                                        "smem": "own", "iters": "cal"})
    row["kernels"][name].update(max_err=2e-5, tol=1e-5, r_err=1e-11,
                                r_tol=1e-12)
    row["verdicts"] = tool.verdicts(row)
    bad = tool.failed([row])
    assert len(bad) == 3
    assert "r error" in bad[1] and "block,own,60" in bad[2]


def test_work_counts_what_the_functions_need():
    """The bounds' FLOPs and bytes: input_sum its input's bytes (the
    thirteen tensors, or the packed record with its padding) and its
    (B,) float64 sums; overlap_probe the record (none for compute), w and
    r, and E x 128 x iters multiply-adds and E x 127 adds a node (none for
    trivial), the calibrated rounds from the head."""
    head = {"chunk": 100, "E": 24, "natural_bytes": 447800,
            "record_bytes": 452800, "iters_cal": 16}
    assert tool.work("input_sum", {"layout": "natural"}, head) == (
        0.0, 447800 + 800)
    assert tool.work("input_sum", {"layout": "minor"}, head) == (
        0.0, 452800 + 800)
    out = 100 * (4 * 24 + 8)
    assert tool.work("overlap_probe", {"body": "trivial", "iters": 60},
                     head) == (0.0, 452800 + out)
    assert tool.work("overlap_probe", {"body": "compute", "iters": 60},
                     head) == (100 * 24 * (2 * 128 * 60 + 127), out)
    assert tool.work("overlap_probe", {"body": "dep", "iters": "cal"},
                     head)[0] == 100 * 24 * (2 * 128 * 16 + 127)
    ms, by = tool.bound(*tool.work("overlap_probe",
                                   {"body": "indep", "iters": 60}, head))
    assert by == "operations" and ms > 0


def test_kernels_line_names_each_site():
    """chip_smoke.py's kernels-line entries of phase 13: one a ported
    tools/ site (five), each with its instances' launches and its fastest
    instance's numbers on the largest class, every key of the contract;
    the three redesigned sites with "status" and "design"."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    big = _row(OVERLAP_MS)
    small = _row({k: tuple(0.25 * x for x in v)
                  for k, v in OVERLAP_MS.items()})
    small.update(E=12, F=24, with_neumann=True, chunk=9579)
    labels = [tool.label(k, kw) for k, kw in tool.CONFIGS]
    launches = {label: i + 1 for i, label in enumerate(labels)}
    entries = smoke.input_entries([small, big], launches)
    by_site = {e["replaces"]: e for e in entries}
    assert set(by_site) == {f"tools/r5_layout_probe.py:{n}"
                            for n in (60, 72, 85, 105)} | {
        "tools/r5_overlap_probe.py:100"}
    c = by_site["tools/r5_layout_probe.py:85"]
    assert c["instance"] == "input_sum[bulk,own]" and c["ms"] == 0.069
    assert c["launches"] == launches["input_sum[wide,own]"] + launches[
        "input_sum[bulk,own]"]
    a = by_site["tools/r5_layout_probe.py:60"]
    assert a["launches"] == sum(launches[f"input_sum[{lay},{m}]"]
                                for lay in ("natural", "prologue")
                                for m in ("own", "k1"))
    assert a["instance"] == "input_sum[natural,own]" and a["ms"] == 0.060
    redesigned = {n: e["design"] for n, e in by_site.items()
                  if e.get("status") == "redesigned"}
    assert set(redesigned) == {f"tools/r5_layout_probe.py:{n}"
                               for n in (60, 72, 105)}
    assert all(redesigned.values())
    o = by_site["tools/r5_overlap_probe.py:100"]
    assert o["library_ms"] is None and len(o["classes"]) == 2 * 32
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for e in entries:
        assert keys <= set(e) and e["route"] == "cuda"
        assert e["source"] == "ninpol_tpu_torch/csrc/input_probes.cu"
    assert sum(e["launches"] for e in entries) == sum(launches.values())


def test_every_input_probe_ports_a_site():
    """Each instance ports an r5_layout_probe.py or r5_overlap_probe.py
    site that site_of finds, through a kernel of ops/input_probes.py; the
    two files' five sites are all ported."""
    names = {tool.answer(k, kw) for k, kw in tool.CONFIGS}
    assert len(names) == 5
    for name in names:
        assert site_of(name).split("/")[1].split(":")[0] in (
            "r5_layout_probe.py", "r5_overlap_probe.py")
        assert getattr(ip, name.split(" (")[0]) in ip.KERNELS
    ours = {s: v for s, v in SITES.items()
            if s.split(":")[0] in ("r5_layout_probe.py", "r5_overlap_probe.py")}
    assert len(ours) == 5 and all(v[0] == "ported" for v in ours.values())
