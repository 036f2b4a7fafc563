"""Kernel 1's input stream: two hand-written CUDA kernels
(``csrc/input_probes.cu``), their wrappers, the pack step and their plain
PyTorch versions.  The counterparts of the TPU probes
tools/r5_layout_probe.py and tools/r5_overlap_probe.py; no route runs
them (``tools/input_probes.py`` times them on the route's inputs):

  input_sum(x, layout, smem_bytes, blocks)
        (B,) float64: each node's record summed, every byte read, with the
        record in one of LAYOUTS: "natural" and "prologue" (x the thirteen
        inputs of ops/gls_solve.py::gls_solve, a dict;
        r5_layout_probe.py:60: "natural" persistent blocks that bring each
        node's spans in by bulk copies a node ahead, "prologue" kernel 1's
        prologue as written), "packed" (:72), "wide" and "bulk" (:85),
        "multi" and "minor" (:105), x a ``Record``; the PERSISTENT layouts
        run ``blocks`` blocks (default the card's SMs times the blocks an
        SM holds)
  overlap_probe(rec, body, schedule, E, iters, seed, smem_bytes, blocks)
        (w (B, E) float32, r (B,) float64) by one of BODIES under one of
        SCHEDULES (r5_overlap_probe.py:100)

A node's record is kernel 1's input for that node: dk, l1, l2, t1m, tt,
lb, nm (float64; lb and nm only with Neumann rows), pair, ks (int32), cv,
fv, isneu, valid (bool, as 0/1 bytes).  Its sum is the float64 sum of its
float64 entries plus the (exact) integer sum of the others.  ``pack``
lays it out as one row of bytes a node (``Record``): the float64 fields,
then the int32, then the bytes, each field zero-padded to 16 bytes;
``Record.to_minor`` transposes it node-minor, (stride / 8, B) words of 8
bytes.

The overlap bodies: "trivial" w = red (the record's sum), "indep" w = the
dummy work seeded from ``seed``, "dep" the dummy work seeded from red,
"compute" the dummy work with no record read (r = 0); the others r = red.
The dummy work (the TPU probe's): acc = seed 1e-6 over (E, 128) float32,
``iters`` rounds of x = 0.999 x + acc, w_e = sum_k x[e, k].  The
schedules: "block", one node a block, copy then compute; "pipelined",
persistent blocks (``blocks``, default the card's SMs times the blocks an
SM holds) that copy a node's record by cp.async.bulk while they compute
the node before.  ``smem_bytes`` requests that much dynamic shared memory
a block (at least what the instance needs), to run at another
instance's occupancy (kernel 1's: ops/gls_solve.py::occupancy).

Each wrapper runs its plain version for CPU tensors and launches its
kernel (built with nvcc on first use, in a library of its own) for CUDA
tensors, or raises.  ``<wrapper>.launches`` counts kernel launches,
``<wrapper>.launches_by`` the same by ``instance(...)``.
``occupancy(kernel, stride, E, smem_bytes, layout= | body=, schedule=)``
gives a launch's registers, spills, shared memory and blocks an SM.
"""
from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch

from . import cuda_lib
from .cuda_lib import CudaLibrary, check_launch, check_tensor, on_card, stream

LAYOUTS = ("natural", "packed", "wide", "bulk", "multi", "minor",
           "prologue")
NATURAL = ("natural", "prologue")     # the layouts of the thirteen tensors
PERSISTENT = ("natural", "packed")    # the layouts that take ``blocks``
BODIES = ("trivial", "indep", "dep", "compute")
SCHEDULES = ("block", "pipelined")
FIELDS = ("dk", "l1", "l2", "t1m", "tt", "lb", "nm", "pair", "ks", "cv",
          "fv", "isneu", "valid")
_F64 = ("dk", "l1", "l2", "t1m", "tt", "lb", "nm")
_I32 = ("pair", "ks")
_U8 = ("cv", "fv", "isneu", "valid")
SLOTS = 128          # the dummy work's columns
MAX_E = 32           # and at most its rows
ALIGN = 16           # a field's bytes, padded


class Record(NamedTuple):
    """Packed node records: ``data`` (B, stride) uint8, or node-minor
    (stride / 8, B) int64 words; ``regions`` the bytes of the float64, int32
    and byte regions, each a multiple of 16."""
    data: torch.Tensor
    regions: tuple
    minor: bool = False

    @property
    def stride(self):
        return sum(self.regions)

    @property
    def nodes(self):
        return self.data.shape[1 if self.minor else 0]

    @property
    def nbytes(self):
        return self.data.numel() * self.data.element_size()

    def to_minor(self):
        """The same records node-minor: word k of node b at [k, b]."""
        if self.minor:
            return self
        words = self.data.view(torch.int64)
        return Record(words.t().contiguous(), self.regions, True)

    def to_major(self):
        if not self.minor:
            return self
        return Record(self.data.t().contiguous().view(torch.uint8),
                      self.regions, False)


# ---------------------------------------------------------------------------
# The pack step and the plain PyTorch versions
# ---------------------------------------------------------------------------
def _fields(inp):
    """The record's tensors by region, each (B, entries), in FIELDS' order
    (lb and nm left out when None)."""
    B = inp["dk"].shape[0]

    def flat(names):
        return [inp[k].reshape(B, -1) for k in names if inp[k] is not None]
    return flat(_F64), flat(_I32), flat(_U8)


def pack(inp):
    """The thirteen inputs of gls_solve (a dict) as a ``Record``: one row a
    node, the float64 fields, then the int32, then the bytes (bool as
    0/1), each zero-padded to 16 bytes."""
    B = inp["dk"].shape[0]
    parts, regions = [], []
    for tensors in _fields(inp):
        size = 0
        for x in tensors:
            raw = x.contiguous().view(torch.uint8) if x.dtype != torch.bool \
                else x.to(torch.uint8)
            raw = raw.reshape(B, -1)
            pad = -raw.shape[1] % ALIGN
            if pad:
                raw = torch.cat([raw, raw.new_zeros((B, pad))], dim=1)
            parts.append(raw)
            size += raw.shape[1]
        regions.append(size)
    return Record(torch.cat(parts, dim=1).contiguous(), tuple(regions))


def _total(f64_parts, int_parts, absolute=False):
    """(B,) float64: the float64 parts' sum plus the integer parts' exact
    sum (with ``absolute`` of their magnitudes)."""
    fix = torch.abs if absolute else (lambda x: x)
    d = sum(fix(x).sum(dim=1) for x in f64_parts)
    n = sum(fix(x.to(torch.int64)).sum(dim=1) for x in int_parts)
    return d + n.double()


def _record_parts(rec):
    """A record's entries by region: (float64 (B, ·), [int32 (B, ·), uint8
    (B, ·)]), padding included (zeros)."""
    raw = rec.to_major().data
    a, b, _ = rec.regions
    return raw[:, :a].view(torch.float64), [raw[:, a:a + b].view(torch.int32),
                                           raw[:, a + b:]]


def input_sum_reference(x, absolute=False):
    """Each node's record sum, float64 (B,), of a ``Record`` or of the
    thirteen inputs (a dict); ``absolute``: the sum of the entries'
    magnitudes, the scale of its rounding."""
    if isinstance(x, Record):
        f, ints = _record_parts(x)
        return _total([f], ints, absolute)
    f, i, u = _fields(x)
    return _total(f, i + u, absolute)


def dummy_work_reference(seed, iters, E):
    """The dummy work of each node from its float32 seed (B,): w (B, E)
    float32 and Σ_k |x[e, k]| (B,) float64, its scale (the same for every
    row e)."""
    acc = (seed.float() * 1e-6)[:, None].expand(-1, SLOTS)
    x = acc.clone()
    for _ in range(iters):
        x = x * 0.999 + acc
    w = x.sum(dim=1)[:, None].expand(-1, E).contiguous()
    return w, x.double().abs().sum(dim=1)


def overlap_probe_reference(rec, body, E, iters=60, seed=1.0):
    """(w, r) of ``overlap_probe``, vectorised (every row of the dummy work
    is the same recurrence)."""
    B = rec.nodes
    dev = rec.data.device
    red = (torch.zeros(B, dtype=torch.float64, device=dev)
           if body == "compute" else input_sum_reference(rec))
    if body == "trivial":
        return red.float()[:, None].expand(-1, E).contiguous(), red
    s = red.float() if body == "dep" else torch.full(
        (B,), seed, dtype=torch.float32, device=dev)
    return dummy_work_reference(s, iters, E)[0], red


# ---------------------------------------------------------------------------
# CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------
def _bind(lib):
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.input_sum_launch.argtypes = [ci, ctypes.POINTER(vp), ll, ci, ci, ci,
                                     ci, ci, ci, ll, ci, vp, vp]
    lib.input_sum_launch.restype = ci
    lib.overlap_probe_launch.argtypes = [ci, ci, vp, ll, ci, ci, ci, ci, ci,
                                         ctypes.c_float, ll, ci, vp, vp, vp]
    lib.overlap_probe_launch.restype = ci
    lib.input_probes_occupancy.argtypes = [
        ci, ci, ci, ci, ci, ci, ll, ctypes.POINTER(ll), ctypes.POINTER(ci),
        ctypes.POINTER(ci), ctypes.POINTER(ci), ctypes.POINTER(ll)]
    lib.input_probes_occupancy.restype = ci


library = CudaLibrary("input_probes", _bind)


def instance(kernel, **kw):
    """An instance's name: the kernel and its arguments' values, as
    launches_by counts it (the layout; the body and schedule)."""
    args = ",".join(str(v) for v in kw.values() if v is not None)
    return f"{kernel}[{args}]" if args else kernel


def _variant(kernel, layout=None, body=None, schedule=None):
    if kernel == "input_sum":
        return 0, LAYOUTS.index(layout)
    return 1, 2 * BODIES.index(body) + SCHEDULES.index(schedule)


def occupancy(kernel, stride, E=0, smem_bytes=0, F=0, with_neumann=False,
              **variant):
    """The launch of ``kernel``'s instance (``layout=``, or ``body=`` and
    ``schedule=``) on records of ``stride`` bytes, E rows of dummy work
    (the natural layout: its inputs at (E, F), ``with_neumann``), at a
    shared memory request of ``smem_bytes`` (``cuda_lib.occupancy``)."""
    what, v = _variant(kernel, **variant)
    return cuda_lib.occupancy(
        library.get().input_probes_occupancy,
        f"{instance(kernel, **variant)} occupancy query (stride={stride}, "
        f"E={E}, F={F}, smem={smem_bytes})", what, v, stride, E, F,
        int(with_neumann), smem_bytes)


def _check_choice(name, value, allowed):
    if value not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {value!r}")


def _check_record(rec, minor):
    if not isinstance(rec, Record):
        raise ValueError(f"expected a Record, got {type(rec).__name__}")
    if len(rec.regions) != 3 or any(r < 0 or r % ALIGN for r in
                                    rec.regions) or not rec.stride:
        raise ValueError(f"regions must be three multiples of {ALIGN}, got "
                         f"{rec.regions}")
    if rec.minor != minor:
        side = "minor" if minor else "major"
        raise ValueError(f"the record must be node-{side}")
    shape = ((rec.stride // 8, rec.nodes) if minor
             else (rec.nodes, rec.stride))
    check_tensor("record", rec.data, shape,
                 torch.int64 if minor else torch.uint8, rec.data.device)


def _check_natural(inp):
    """The thirteen inputs as gls_solve takes them; (B, E, F, with
    Neumann rows)."""
    from .gls_solve import _check_inputs

    if set(inp) != set(FIELDS):
        raise ValueError(f"natural inputs must be {FIELDS}, got "
                         f"{tuple(inp)}")
    B, E, F = _check_inputs(inp)
    return B, E, F, inp["lb"] is not None


def _launch(wrapper, name, what, fn, device, *args):
    """Launch under ``device``'s guard, on its stream (the library reads
    the current device when it sizes the launch), and count it for the
    wrapper and its instance ``name``."""
    with torch.cuda.device(device):
        err = getattr(library.get(), fn)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args], stream(device))
    check_launch(err, what)
    wrapper.launches += 1
    wrapper.launches_by[name] += 1


def input_sum(x, layout, smem_bytes=0, blocks=None):
    """Each node's record sum, (B,) float64: ``x`` the thirteen inputs of
    gls_solve (a dict) for "natural" and "prologue", else a ``Record``
    (node-minor for "minor"); ``blocks`` the persistent layouts' grid."""
    _check_choice("layout", layout, LAYOUTS)
    if smem_bytes < 0:
        raise ValueError(f"smem_bytes must be >= 0, got {smem_bytes}")
    if blocks is not None and (layout not in PERSISTENT or blocks < 1):
        raise ValueError(f"blocks (>= 1) is for the layouts {PERSISTENT}, "
                         f"got {blocks} for {layout!r}")
    if layout in NATURAL:
        if not isinstance(x, dict):
            raise ValueError(f"the {layout} layout takes the thirteen "
                             f"inputs, a dict")
        B, E, F, wneu = _check_natural(x)
        lead = x["dk"]
    else:
        _check_record(x, layout == "minor")
        B, E, F, wneu, lead = x.nodes, 0, 0, False, x.data
    if not on_card(lead, "input_sum"):
        return input_sum_reference(x)
    out = torch.empty(B, dtype=torch.float64, device=lead.device)
    if B:
        if layout in NATURAL:
            ptrs = [None if x[k] is None else x[k].data_ptr() for k in FIELDS]
            regions = (0, 0, 0)
        else:
            ptrs = [x.data.data_ptr()] + [None] * (len(FIELDS) - 1)
            regions = x.regions
        _launch(input_sum, instance("input_sum", layout=layout),
                f"input_sum ({layout}, B={B})", "input_sum_launch",
                lead.device, LAYOUTS.index(layout),
                (ctypes.c_void_p * len(FIELDS))(*ptrs), B, E, F, int(wneu),
                *regions, int(smem_bytes), int(blocks or 0), out)
    return out


def overlap_probe(rec, body, schedule, E, iters=60, seed=1.0, smem_bytes=0,
                  blocks=None):
    """(w (B, E) float32, r (B,) float64) of ``body`` under ``schedule`` on
    the packed records ``rec`` (node-major)."""
    _check_choice("body", body, BODIES)
    _check_choice("schedule", schedule, SCHEDULES)
    _check_record(rec, False)
    if not 1 <= E <= MAX_E:
        raise ValueError(f"E must be in [1, {MAX_E}], got {E}")
    if iters < 0 or smem_bytes < 0 or (blocks is not None and blocks < 1):
        raise ValueError(f"iters and smem_bytes must be >= 0 and blocks >= "
                         f"1, got {iters}, {smem_bytes}, {blocks}")
    if not on_card(rec.data, "overlap_probe"):
        return overlap_probe_reference(rec, body, E, iters, seed)
    B = rec.nodes
    dev = rec.data.device
    w = torch.empty((B, E), dtype=torch.float32, device=dev)
    r = torch.empty(B, dtype=torch.float64, device=dev)
    if B:
        _launch(overlap_probe, instance("overlap_probe", body=body,
                                        schedule=schedule),
                f"overlap_probe ({body}, {schedule}, B={B}, E={E}, "
                f"iters={iters})", "overlap_probe_launch", dev,
                BODIES.index(body), SCHEDULES.index(schedule), rec.data, B,
                *rec.regions, E, int(iters), float(seed), int(smem_bytes),
                int(blocks or 0), w, r)
    return w, r


KERNELS = (input_sum, overlap_probe)
for _w in KERNELS:
    _w.launches = 0
    _w.launches_by = collections.Counter()
