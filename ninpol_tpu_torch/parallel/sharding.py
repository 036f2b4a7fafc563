"""Multi-device interpolation: one process driving several torch devices.

Counterpart of ninpol_tpu/parallel/sharding.py.  ninpol_tpu's ``mesh=N`` is
one controller driving N devices, and ``interpolate()`` returns one scipy
CSR in one process.  Here that controller is one Python process holding a
tuple of torch devices (``Mesh``).  The methods' prepare() splits each
stencil class's node list evenly over the mesh's shards (``split_nodes``,
as ``PartitionSpec(axis)`` splits ninpol_tpu's node axis), launches every
shard's chunks on its own device, chunk i of every shard before chunk i + 1
(``schedule``; launches are asynchronous per device), and copies each chunk's
results device to device onto the primary device (``to_device``), where
they are scattered into the output.  No process group, collective or
launcher is involved.

The grid arrays are placed in one of two ways (``DeviceGrid``):

* replicated (the default): one copy per distinct device (``Replicated``),
  so every stencil gather reads its own device's copy;
* partitioned (``shard_geometry=True``): each per-point, per-cell and
  per-face array is cut into equal row ranges on dim 0, zero-padded to a
  multiple of the mesh size, one part per shard (``PartitionedRows``).  A
  gather reads every part on its owner's device and copies the rows the
  caller needs to the caller's device: the explicit form of the
  all-gathers XLA inserts for ninpol_tpu.

A mesh may name one device more than once: ``["cuda:0", "cuda:0"]`` is two
logical shards on one card, which share one replicated copy.

``make_mesh(n)`` takes the first min(n, count) cards, as ninpol_tpu's takes
the devices it finds, and logs the shortfall; it raises where there is no
card at all (no CPU fallback), as does a list naming a card that does not
exist.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..utils.tracing import PREFIX, span, upload

# spans around the cross-part gathers and the device-to-device merges
# (their names are what a trace reader looks for)
GATHER_RANGE = PREFIX + "mesh_gather"
MERGE_RANGE = PREFIX + "mesh_merge"

_log = logging.getLogger(__name__)


def _cuda_count():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _device(d):
    """A torch.device with its CUDA index made explicit; raises for a
    CUDA device torch cannot find."""
    d = torch.device(d)
    if d.type == "cpu":
        return d
    if d.type != "cuda":
        raise ValueError(f"a mesh holds cpu or cuda devices, not {d}")
    count = _cuda_count()
    index = d.index if d.index is not None else (
        torch.cuda.current_device() if count else 0)
    if index >= count:
        raise RuntimeError(f"{d} was asked for and torch finds {count} CUDA "
                           f"device(s); there is no CPU fallback")
    return torch.device("cuda", index)


class Mesh:
    """A tuple of torch devices, one per shard, all of one type; the first
    is the primary device, which receives the results.  A device may
    appear more than once (logical shards on one device)."""

    def __init__(self, devices):
        devices = tuple(_device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devices}) > 1:
            raise ValueError(f"a mesh holds devices of one type, got "
                             f"{devices}")
        self.devices = devices

    @property
    def primary(self):
        return self.devices[0]

    @property
    def size(self):
        return len(self.devices)

    @property
    def distinct(self):
        """The distinct devices, in mesh order."""
        return tuple(dict.fromkeys(self.devices))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self):
        return hash(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices=None, device=None):
    """A mesh of ``n_devices`` shards.  On CUDA (the default ``device``):
    cuda:0 ... cuda:N-1 for N = min(n_devices, count), as ninpol_tpu
    slices its device list, every card when ``n_devices`` is None; a
    shortfall is logged (a warning of this module's logger), and no card
    at all raises.  With ``device="cpu"``: N logical shards on the CPU
    (one when ``n_devices`` is None).  Only the type of ``device`` is
    read."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        return Mesh(["cpu"] * (1 if n_devices is None else int(n_devices)))
    if kind != "cuda":
        raise ValueError(f"a mesh holds cpu or cuda devices, not {kind}")
    count = _cuda_count()
    if count == 0:
        raise RuntimeError(
            "a mesh of CUDA devices was asked for and torch finds none; "
            "there is no CPU fallback (pass device='cpu' for CPU shards)")
    n = count if n_devices is None else min(int(n_devices), count)
    if n_devices is not None and n < int(n_devices):
        _log.warning("a mesh of %d CUDA devices was asked for and torch "
                     "finds %d; the mesh takes %d", int(n_devices), count, n)
    return Mesh([f"cuda:{i}" for i in range(n)])


def as_mesh(mesh, device=None):
    """``mesh`` as a Mesh: an int goes through ``make_mesh(mesh,
    device)``, a sequence of devices is taken as given, None stays None.
    A ``device`` of another type than the mesh's raises."""
    if mesh is None or isinstance(mesh, Mesh):
        out = mesh
    elif isinstance(mesh, int) and not isinstance(mesh, bool):
        return make_mesh(mesh, device)
    else:
        out = Mesh(mesh)
    if out is not None and device is not None \
            and torch.device(device).type != out.primary.type:
        raise ValueError(f"device={device!r} does not match the mesh {out}")
    return out


def split_nodes(n, mesh):
    """The contiguous, even split of an n-long node axis over the shards of
    ``mesh`` (a Mesh or a shard count): [(lo, hi)] per shard, each
    ceil(n / N) long but the last ones, as ``PartitionSpec(axis)`` splits
    an axis padded to a multiple of N."""
    size = mesh if isinstance(mesh, int) else mesh.size
    per = -(-int(n) // size)
    return [(min(k * per, n), min((k + 1) * per, n)) for k in range(size)]


def schedule(n, mesh, chunk):
    """The chunks of an n-long node list split over the shards of ``mesh``
    (``split_nodes``), each shard's part cut at ``chunk``: [(shard, lo,
    hi)], chunk i of every shard before chunk i + 1, so that no device
    waits for the host to finish another shard's part."""
    parts = split_nodes(n, mesh)
    longest = max(hi - lo for lo, hi in parts)
    return [(k, lo + i, min(lo + i + chunk, hi))
            for i in range(0, longest, chunk)
            for k, (lo, hi) in enumerate(parts) if lo + i < hi]


def to_device(device, *tensors):
    """The tensors copied onto ``device`` (asynchronous device to device:
    torch orders the copy after the source device's work)."""
    with span(MERGE_RANGE):
        return tuple(t.to(device, non_blocking=True) for t in tensors)


class Replicated:
    """One copy of a host array on each distinct device of a mesh."""

    def __init__(self, host, mesh):
        t = torch.as_tensor(np.ascontiguousarray(host))
        self.copies = {d: upload(t, d) for d in mesh.distinct}

    def on(self, device):
        return self.copies[device]


class PartitionedRows:
    """A host array cut into equal row ranges on dim 0, zero-padded to a
    multiple of the mesh size, one part per shard on the shard's device
    (ninpol_tpu's geometry sharding, device_grid.py:91-104).

    ``x[idx]`` and ``x[idx, cols]`` (``cols`` a slice; ``idx`` an integer
    tensor of any shape with entries in [0, n_rows)) return the rows on
    idx's device: each part gathers the indices clamped into its range on
    its own device, the result is copied to idx's device and kept where
    the part owns the row.  No host sync: the owners are never read on the
    host.  The price: with N parts a gather moves N times its output across
    devices and holds N output-sized temporaries on idx's device."""

    def __init__(self, host, mesh):
        a = np.ascontiguousarray(host)
        self.n_rows = a.shape[0]
        self.rows = max(-(-self.n_rows // mesh.size), 1)
        pad = self.rows * mesh.size - self.n_rows
        if pad:
            a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
        t = torch.as_tensor(a)
        self.shape = tuple(t.shape)
        self.parts = tuple(
            upload(t[k * self.rows:(k + 1) * self.rows], d)
            for k, d in enumerate(mesh.devices))

    def __getitem__(self, key):
        idx, cols = key if isinstance(key, tuple) else (key, slice(None))
        with span(GATHER_RANGE):
            idx = idx.long()
            owner = idx // self.rows
            out = None
            for k, part in enumerate(self.parts):
                src = part[:, cols] if part.dim() > 1 else part
                li = (idx - k * self.rows).clamp_(0, self.rows - 1)
                got = src.index_select(0, li.reshape(-1).to(part.device))
                got = got.reshape(idx.shape + got.shape[1:]).to(idx.device)
                if out is None:
                    out = got
                else:
                    mask = (owner == k).reshape(
                        idx.shape + (1,) * (got.dim() - idx.dim()))
                    out = torch.where(mask, got, out)
            return out


def local(x, device):
    """What a shard on ``device`` indexes: a Replicated array's copy there;
    a PartitionedRows or a plain tensor as it is."""
    return x.on(device) if isinstance(x, Replicated) else x

