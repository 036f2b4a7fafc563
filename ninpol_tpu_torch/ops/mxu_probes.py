"""Kernel 1's Gram and Q probes on the tensor cores: four hand-written CUDA
kernels (``csrc/mxu_probes.cu``), their wrappers and their plain PyTorch
versions.  The counterparts of the TPU probes tools/mxu_probe.py and
tools/r5_mxu_shapes.py; no route runs them (``tools/mxu_probes.py``
times them on the route's inputs):

  node_transpose(x, direction, nodes)
        "in": node-minor (T, r, c, 128) -> node-major (nodes, r, c)
        (mxu_probe.py:108); "out": node-major (B, r, c) -> node-minor
        (ceil(B / 128), r, c, 128), the last tile's slots past B zero
        (:150)
  gram_tc(A, precision, layout, split, nodes, blocks, smem_bytes)
        G = A^T A, (B, m, n) -> (B, n, n) node-major (:123, :138), or
        node-minor (T, m, n, 128) -> (T, n, n, 128) (:166; the shape sweep
        r5_mxu_shapes.py:84, which may ``split`` the rows: G = A[:s]^T
        A[:s] + A[s:]^T A[s:], each part rounded to float32, then added)
  q_tc(A, Li, precision, blocks)
        Q = A Li^T, (B, m, n), (B, n, n) -> (B, m, n) (:185); Li general
  gram_q_gram_tc(A, Li, precision, layout, nodes, blocks)
        (G1, G2) = (A^T A, Q^T Q) with Q = A Li^T rounded to float32
        (:215), in either layout

``precision`` is one of PRECISIONS, the operands rounded as the tensor
cores take them:
  "dmma"    float32 operands exactly (FP64 tensor cores), float64 sums,
            each output rounded once to float32;
  "tf32x3"  hi = tf32(a), lo = tf32(a - hi), the TF32 rounding to nearest
            with ties away from zero (cvt.rna), hi lo + lo hi + hi hi in
            float32 sums;
  "bf16"    operands rounded to bf16 (to nearest, ties to even), float32
            sums; gram_tc node-major only (the TPU's DEFAULT pass).
Each plain version applies the same rounding, bit for bit, so a kernel
and its plain version differ only in the order of their sums.

All float32; n <= 128 (gram_q_gram_tc and bf16 n <= 80); m any for
gram_tc, and for q_tc and gram_q_gram_tc as far as a node's A and Li fit
in shared memory with their operand planes (at n = 80: ~475 rows for
q_tc, ~270 for gram_q_gram_tc).  Every kernel but node_transpose runs
persistent blocks (``blocks``, default the card's SMs times the blocks an
SM holds) that walk the nodes (node-minor gram_tc: groups of 8 nodes and
its super tiles); q_tc's A and output agree modulo 16 bytes on the card,
as torch's allocations do, and node-minor gram_tc's A is 16-byte
aligned.  gram_tc's ``smem_bytes`` asks for at least that much shared
memory a block (another kernel's, to run at its blocks an SM).  Node-minor
tensors hold 128 nodes a tile; ``nodes`` (default all the tiles' slots)
says how many are real: the kernels compute those and the wrappers zero
the others.  Each wrapper runs its plain version for CPU tensors and
launches its kernel (built with nvcc on first use, in a library of its
own) for CUDA tensors, or raises.  ``<wrapper>.launches`` counts kernel
launches, ``<wrapper>.launches_by`` the same by ``instance(...)``.
``occupancy(kernel, n, precision, layout, split, m, smem_bytes)`` gives a
launch's registers, spills, shared memory and blocks an SM.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from . import cuda_lib
from .cuda_lib import (CudaLibrary, check_launch, check_request, check_tensor,
                       on_card, stream)

_F32 = torch.float32
NT = 128                                  # nodes a node-minor tile
PRECISIONS = ("dmma", "tf32x3", "bf16")
LAYOUTS = ("major", "minor")
MAX_N = 128
MAX_N_COMPOSITE = 80
# the library's ids
_WHAT = {"gram_tc": 0, "q_tc": 1, "gram_q_gram_tc": 2, "node_transpose": 3}
_PREC = {p: i for i, p in enumerate(PRECISIONS)}
_DIRECTIONS = ("in", "out")


# ---------------------------------------------------------------------------
# Operand roundings, as the tensor cores take them
# ---------------------------------------------------------------------------
def round_tf32(x):
    """float32 x rounded to TF32 (10 fraction bits) as cvt.rna.tf32.f32
    does: to nearest, ties away from zero, on the int32 view (the
    magnitude plus half a unit of the 13 dropped bits, then truncated);
    infinities and NaNs pass."""
    bits = x.contiguous().view(torch.int32)
    special = (bits & 0x7F800000) == 0x7F800000
    r = (bits + 0x1000) & ~0x1FFF
    return torch.where(special, bits, r).view(_F32)


def split_tf32(x):
    """(hi, lo) = (tf32(x), tf32(x - hi)): x - hi is exact in float32."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def round_bf16(x):
    """float32 x rounded to bf16 as cvt.rn.bf16.f32 does (to nearest, ties
    to even), as float32: on the int32 view, the magnitude plus 0x7fff
    plus the kept part's lowest bit, then truncated to 16 bits; NaNs stay
    NaN (quiet)."""
    bits = x.contiguous().view(torch.int32)
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    r = (bits + 0x7FFF + ((bits >> 16) & 1)) & ~0xFFFF
    return torch.where(nan, bits | 0x400000, r).view(_F32)


def _mm(X, Y, precision):
    """X @ Y with the operands rounded as ``precision`` takes them: float64
    sums for "dmma" (returned in float64), float32 sums otherwise (TF32
    off, so products of rounded operands are exact)."""
    if precision == "dmma":
        return X.double() @ Y.double()
    with _full_float32():
        if precision == "bf16":
            return round_bf16(X) @ round_bf16(Y)
        xh, xl = split_tf32(X)
        yh, yl = split_tf32(Y)
        return xl @ yh + xh @ yl + xh @ yh


class _full_float32:
    """float32 products in float32 on the card (TF32 off) for the block."""

    def __enter__(self):
        self.was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.was


# ---------------------------------------------------------------------------
# Plain PyTorch versions (node-major; node-minor through node_transpose)
# ---------------------------------------------------------------------------
def node_transpose_reference(x, direction, nodes=None):
    if direction == "in":
        T, r, c, _ = x.shape
        B = T * NT if nodes is None else nodes
        return x.permute(0, 3, 1, 2).reshape(T * NT, r, c)[:B].contiguous()
    B, r, c = x.shape
    T = -(-B // NT)
    pad = torch.zeros((T * NT, r, c), dtype=x.dtype, device=x.device)
    pad[:B] = x
    return pad.reshape(T, NT, r, c).permute(0, 2, 3, 1).contiguous()


def gram_tc_reference(A, precision="dmma", split=0):
    """A^T A of node-major A, each of its ``split`` parts rounded to
    float32 and then added."""
    At = A.transpose(1, 2)
    if not split:
        return _mm(At, A, precision).float()
    return (_mm(At[:, :, :split], A[:, :split], precision).float()
            + _mm(At[:, :, split:], A[:, split:], precision).float())


def q_tc_reference(A, Li, precision="dmma"):
    return _mm(A, Li.transpose(1, 2), precision).float()


def gram_q_gram_tc_reference(A, Li, precision="dmma"):
    Q = q_tc_reference(A, Li, precision)
    return gram_tc_reference(A, precision), gram_tc_reference(Q, precision)


# ---------------------------------------------------------------------------
# CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------
def _bind(lib):
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mxu_probe_launch.argtypes = [ci, ci, ci, vp, vp, vp, vp, ll, ci, ci,
                                     ci, ll, ll, vp]
    lib.mxu_probe_launch.restype = ci
    lib.node_transpose_launch.argtypes = [vp, vp, ll, ci, ci, vp]
    lib.node_transpose_launch.restype = ci
    lib.mxu_probes_occupancy.argtypes = [
        ci, ci, ci, ci, ci, ci, ll, ctypes.POINTER(ll), ctypes.POINTER(ci),
        ctypes.POINTER(ci), ctypes.POINTER(ci), ctypes.POINTER(ll)]
    lib.mxu_probes_occupancy.restype = ci


library = CudaLibrary("mxu_probes", _bind)


def instance(kernel, **kw):
    """An instance's name: the kernel and the arguments that pick its
    template instance (precision, layout, direction), as launches_by
    counts it."""
    args = ",".join(str(v) for v in kw.values() if v is not None)
    return f"{kernel}[{args}]" if args else kernel


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


def occupancy(kernel, n, precision="dmma", layout="major", split=0, m=1,
              smem_bytes=0):
    """The launch of ``kernel`` at m x n (node_transpose: any) at a shared
    memory request of ``smem_bytes`` on the current card
    (``cuda_lib.occupancy``)."""
    check_request(smem_bytes)
    return cuda_lib.occupancy(
        library.get().mxu_probes_occupancy,
        f"{kernel} occupancy query (m={m}, n={n}, {precision}, {layout}, "
        f"split={split}, smem={smem_bytes})",
        _WHAT[kernel], _PREC[precision], int(layout == "minor"), m, n, split,
        int(smem_bytes))


def _check_precision(precision, allowed=PRECISIONS):
    if precision not in allowed:
        raise ValueError(f"precision must be one of {allowed}, got "
                         f"{precision!r}")


def _check_layout(layout):
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")


def _node_count(x, layout, nodes):
    """The real nodes of ``x``: all for node-major; for node-minor
    ``nodes``, at most its tiles' slots (default all of them)."""
    if layout == "major":
        return x.shape[0]
    slots = x.shape[0] * NT
    if nodes is None:
        return slots
    if not 0 <= nodes <= slots:
        raise ValueError(f"nodes must be in [0, {slots}], got {nodes}")
    return nodes


def _matrix_dims(name, A, layout):
    """(m, n) of A in ``layout``; raises for a wrong rank."""
    want = 3 if layout == "major" else 4
    if A.dim() != want or (layout == "minor" and A.shape[3] != NT):
        form = "(B, m, n)" if want == 3 else "(T, m, n, 128)"
        raise ValueError(f"{name} must be {form}, got {tuple(A.shape)}")
    return A.shape[1], A.shape[2]


def _minor_call(fn, layout, nodes, *xs):
    """fn on node-major tensors; for node-minor ones through
    node_transpose_reference, slots past ``nodes`` zero."""
    if layout == "major":
        return fn(*xs)
    outs = fn(*(node_transpose_reference(x, "in", nodes) for x in xs))
    if isinstance(outs, tuple):
        return tuple(node_transpose_reference(o, "out") for o in outs)
    return node_transpose_reference(outs, "out")


def node_transpose(x, direction, nodes=None):
    """"in": node-minor (T, r, c, 128) -> node-major (nodes, r, c); "out":
    node-major (B, r, c) -> node-minor (ceil(B / 128), r, c, 128), zeros
    past B."""
    if direction not in _DIRECTIONS:
        raise ValueError(f"direction must be one of {_DIRECTIONS}, got "
                         f"{direction!r}")
    layout = "minor" if direction == "in" else "major"
    _matrix_dims("x", x, layout)
    check_tensor("x", x, tuple(x.shape), _F32, x.device)
    B = _node_count(x, layout, nodes)
    r, c = x.shape[1:3]
    out_shape = ((B, r, c) if direction == "in"
                 else (-(-B // NT), r, c, NT))
    if not on_card(x, "node_transpose"):
        return node_transpose_reference(x, direction, nodes)
    out = torch.empty(out_shape, dtype=_F32, device=x.device)
    if B and r * c:
        _launch(node_transpose, instance("node_transpose",
                                         direction=direction),
                f"node_transpose ({direction}, B={B}, {r}x{c})",
                "node_transpose_launch", x.device, x, out, B, r * c,
                _DIRECTIONS.index(direction))
    return out


def _product(wrapper, name, prec, layout, A, Li, outs, B, m, n, split,
             blocks=None, smem_bytes=0):
    _launch(wrapper, name, f"{wrapper.__name__} ({prec}, {layout}, B={B}, "
                           f"m={m}, n={n}, split={split}, "
                           f"smem={smem_bytes})",
            "mxu_probe_launch", A.device, _WHAT[wrapper.__name__], _PREC[prec],
            int(layout == "minor"), A, Li, *outs, B, m, n, split, blocks or 0,
            int(smem_bytes))


def _check_blocks(blocks):
    if blocks is not None and blocks < 1:
        raise ValueError(f"blocks must be >= 1, got {blocks}")


def _check_n(n, limit):
    if not 1 <= n <= limit:
        raise ValueError(f"n must be in [1, {limit}], got {n}")


def gram_tc(A, precision="dmma", layout="major", split=0, nodes=None,
            blocks=None, smem_bytes=0):
    """A^T A on the tensor cores: (B, m, n) -> (B, n, n), or node-minor
    (T, m, n, 128) -> (T, n, n, 128); ``split`` > 0 sums rows [0, split)
    and [split, m) apart, each rounded to float32; ``blocks`` persistent
    blocks (default: the card's SMs x the blocks an SM holds), at least
    ``smem_bytes`` of shared memory a block."""
    _check_precision(precision)
    _check_layout(layout)
    _check_blocks(blocks)
    check_request(smem_bytes)
    if precision == "bf16" and layout != "major":
        raise ValueError("gram_tc takes bf16 node-major only")
    m, n = _matrix_dims("A", A, layout)
    _check_n(n, MAX_N_COMPOSITE if precision == "bf16" else MAX_N)
    if not 0 <= split < m:
        raise ValueError(f"split must be in [0, {m}), got {split}")
    B = _node_count(A, layout, nodes)
    check_tensor("A", A, tuple(A.shape), _F32, A.device)
    if not on_card(A, "gram_tc"):
        return _minor_call(lambda X: gram_tc_reference(X, precision, split),
                           layout, nodes, A)
    shape = (A.shape[0], n, n) + ((NT,) if layout == "minor" else ())
    out = (torch.empty if layout == "major" else torch.zeros)(
        shape, dtype=_F32, device=A.device)
    if B:
        _product(gram_tc, instance("gram_tc", precision=precision,
                                   layout=layout),
                 precision, layout, A, None, (out, None), B, m, n, split,
                 blocks, smem_bytes)
    return out


def q_tc(A, Li, precision="dmma", blocks=None):
    """A Li^T on the tensor cores: (B, m, n), (B, n, n) -> (B, m, n);
    ``blocks`` persistent blocks (default: the card's SMs x the blocks an
    SM holds)."""
    _check_precision(precision, PRECISIONS[:2])
    _check_blocks(blocks)
    m, n = _matrix_dims("A", A, "major")
    _check_n(n, MAX_N)
    B = A.shape[0]
    check_tensor("A", A, (B, m, n), _F32, A.device)
    check_tensor("Li", Li, (B, n, n), _F32, A.device)
    if not on_card(A, "q_tc"):
        return q_tc_reference(A, Li, precision)
    out = torch.empty_like(A)
    if B:
        _product(q_tc, instance("q_tc", precision=precision), precision,
                 "major", A, Li, (out, None), B, m, n, 0, blocks)
    return out


def gram_q_gram_tc(A, Li, precision="dmma", layout="major", nodes=None,
                   blocks=None):
    """(A^T A, Q^T Q), Q = A Li^T rounded to float32, on the tensor cores,
    node-major ((B, m, n), (B, n, n) -> 2 x (B, n, n)) or node-minor
    ((T, m, n, 128), (T, n, n, 128) -> 2 x (T, n, n, 128)); ``blocks``
    persistent blocks (default: the card's SMs x the blocks an SM
    holds)."""
    _check_precision(precision, PRECISIONS[:2])
    _check_layout(layout)
    _check_blocks(blocks)
    m, n = _matrix_dims("A", A, layout)
    _check_n(n, MAX_N_COMPOSITE)
    B = _node_count(A, layout, nodes)
    check_tensor("A", A, tuple(A.shape), _F32, A.device)
    li_shape = ((A.shape[0], n, n) if layout == "major"
                else (A.shape[0], n, n, NT))
    check_tensor("Li", Li, li_shape, _F32, A.device)
    if not on_card(A, "gram_q_gram_tc"):
        return _minor_call(
            lambda X, L: gram_q_gram_tc_reference(X, L, precision), layout,
            nodes, A, Li)
    alloc = torch.empty if layout == "major" else torch.zeros
    outs = tuple(alloc(li_shape, dtype=_F32, device=A.device)
                 for _ in range(2))
    if B:
        _product(gram_q_gram_tc, instance("gram_q_gram_tc",
                                          precision=precision, layout=layout),
                 precision, layout, A, Li, outs, B, m, n, 0, blocks)
    return outs


KERNELS = (node_transpose, gram_tc, q_tc, gram_q_gram_tc)
for _w in KERNELS:
    _w.launches = 0
    _w.launches_by = collections.Counter()
