"""Device-resident padded grid arrays + stencil classes.

Counterpart of ninpol_tpu/_methods/device_grid.py.  The reference walks
ragged CSR adjacency per node (e.g. gls.pyx:161-219); here the grid's CSR
structures become padded 2D tensors on the target device once, and target
nodes are sorted into (E, F) stencil-size classes so a batch of nodes
shares one padded shape.  The GLS solve kernel takes E and F at run time,
so the classes only bound the padding (and with it memory and work).
"""
from __future__ import annotations

import numpy as np
import torch

from .._grid.topology import csr_to_padded
from ..parallel.sharding import PartitionedRows, Replicated, local
from ..utils.tracing import upload


def _round_up(x, m):
    return int(-(-int(x) // m) * m)


# Stencil-size ladder: a class's E and F snap UP to a ladder value, so
# classes (and the padding inside them) match the reference's.
_SIZE_LADDER = (4, 8, 12, 16, 20, 24, 28, 32, 36, 40, 48, 56, 64, 80, 96,
                112, 128, 160, 192, 224, 256)


def _ladder_up(x):
    x = int(x)
    for v in _SIZE_LADDER:
        if v >= x:
            return v
    return _round_up(x, 64)


class DeviceGrid:
    """Padded mirrors of the Grid structures the methods read, on
    ``device``: the CUDA card unless the caller names another device
    (``"cpu"`` for the CPU).  Raises when the device is CUDA and there is
    no card; it never falls back to the CPU.  ``(grid, mesh,
    shard_geometry)`` are ninpol_tpu's parameters, in its order; ``device``
    follows them.

    With ``mesh`` (a ``parallel.Mesh``) the arrays are placed over the
    mesh's shards, ``device`` is the mesh's primary device, and the
    methods' prepare() splits their nodes over the shards (parallel/sharding.py):
    replicated, one copy per distinct device (``Replicated``), or with
    ``shard_geometry`` partitioned on dim 0 (``PartitionedRows``).
    ``on(shard)`` is the view a shard gathers from.  Without a mesh the
    arrays are plain tensors and ``shard_geometry`` places nothing (it
    picks GLS's unfused route, ``Interpolator``).  The host planning
    (``assembling``, ``buckets``) runs once, on the host, either way."""

    def __init__(self, grid, mesh=None, shard_geometry=False, device=None):
        if mesh is not None:
            if device is not None and torch.device(device).type != \
                    mesh.primary.type:
                raise ValueError(f"device={device!r} does not match the "
                                 f"mesh {mesh}")
            self.device = mesh.primary
        else:
            self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ninpol_tpu_torch runs on the CUDA card by default and "
                "torch finds no CUDA device; pass device='cpu' to run on "
                "the CPU")
        self.mesh = mesh
        self.shard_geometry = bool(shard_geometry) and mesh is not None
        # one device per shard (one shard without a mesh)
        self.shards = mesh.devices if mesh is not None else (self.device,)
        self.grid = grid
        self.dim = grid.dim
        self.n_points = grid.n_points
        self.n_elems = grid.n_elems
        self.n_faces = grid.n_faces

        # Host padded adjacency (int32: indices < 2^31).  Widths round up
        # to the ladder so a class's E/F never exceeds the array width.
        self.esup2d_h = csr_to_padded(
            grid.esup_ptr, grid.esup,
            _ladder_up(max(grid.MX_ELEMENTS_PER_POINT, 1))
        ).astype(np.int32)
        self.esup_cnt_h = np.diff(grid.esup_ptr).astype(np.int32)
        self.fsup2d_h = csr_to_padded(
            grid.fsup_ptr, grid.fsup,
            _ladder_up(max(grid.MX_FACES_PER_POINT, 1))
        ).astype(np.int32)
        self.fsup_cnt_h = np.diff(grid.fsup_ptr).astype(np.int32)
        esuf_w = max(grid.MX_ELEMENTS_PER_FACE, 2)
        self.esuf2d_h = csr_to_padded(
            grid.esuf_ptr, grid.esuf, esuf_w).astype(np.int32)

        place = self.place
        self.esup2d = place(self.esup2d_h)
        self.esup_cnt = place(self.esup_cnt_h)
        self.fsup2d = place(self.fsup2d_h)
        self.fsup_cnt = place(self.fsup_cnt_h)
        # the esuf cell pair of every face (second < 0: boundary face)
        self.esuf_pair = place(self.esuf2d_h[:, :2])
        self.point_coords = place(np.asarray(grid.point_coords, np.float64))
        self.centroids = place(np.asarray(grid.centroids, np.float64))

    def place(self, a):
        """A host array placed as this grid's arrays are: a tensor on the
        device, a ``Replicated`` or a ``PartitionedRows``."""
        a = np.ascontiguousarray(a)
        if self.mesh is None:
            return upload(a, self.device)
        if self.shard_geometry:
            return PartitionedRows(a, self.mesh)
        return Replicated(a, self.mesh)

    def on(self, shard):
        """The arrays shard ``shard`` gathers from, on its device."""
        return GridView(self, shard)

    def geometry_bytes(self, extra=()):
        """Bytes of the grid arrays (and of the placed ``extra`` arrays)
        each shard holds on its device: a replicated copy is counted for
        every shard on its device, a partitioned array's part for its
        own shard."""
        out = []
        for k, dev in enumerate(self.shards):
            total = 0
            for x in [getattr(self, n) for n in GridView.ARRAYS] + list(
                    extra):
                if isinstance(x, PartitionedRows):
                    x = x.parts[k]
                elif isinstance(x, Replicated):
                    x = x.on(dev)
                total += x.element_size() * x.numel()
            out.append(total)
        return out

    def assembling(self, target_points):
        """Host mask of target nodes whose GLS system has a face that is
        not on the boundary (n_bface < n_face, gls.pyx:266); the others
        get zero weights without a solve."""
        g = self.grid
        counts = np.diff(g.fsup_ptr)
        owner = np.repeat(np.arange(g.n_points), counts)
        n_bface = np.bincount(
            owner, weights=np.asarray(g.boundary_faces)[g.fsup] != 0,
            minlength=g.n_points)
        tp = np.asarray(target_points)
        return n_bface[tp] < self.fsup_cnt_h[tp]

    def buckets(self, target_points, active_mask, max_buckets=3,
                min_bucket=2048):
        """Sort the *active* positions of ``target_points`` into stencil
        classes.

        Returns a list of dicts with
          pos    positions into target_points (np.int64)
          nodes  global node ids (np.int64)
          E, F   the class's padded cell and face counts

        Classes are quantile cuts on n_elem snapped up to the ladder (the
        reference's cuts); a class smaller than ``min_bucket`` joins the
        next larger one.  Chunking a class is the caller's business."""
        target_points = np.asarray(target_points)
        pos_all = np.nonzero(active_mask)[0]
        if len(pos_all) == 0:
            return []
        nodes_all = target_points[pos_all].astype(np.int64)
        ne = self.esup_cnt_h[nodes_all].astype(np.int64)
        nf = self.fsup_cnt_h[nodes_all].astype(np.int64)

        qs = [0.5, 0.85, 1.0][-max_buckets:]
        cuts = sorted({_ladder_up(np.quantile(ne, q)) for q in qs})
        assigned = np.full(len(pos_all), -1)
        for ci, cut in enumerate(cuts):
            assigned[(assigned < 0) & (ne <= cut)] = ci

        out = []
        carry = np.zeros(len(pos_all), dtype=bool)
        for ci in range(len(cuts)):
            sel = (assigned == ci) | carry
            if ci + 1 < len(cuts) and sel.sum() < min_bucket:
                carry = sel
                continue
            carry = np.zeros(len(pos_all), dtype=bool)
            if not sel.any():
                continue
            out.append({"pos": pos_all[sel], "nodes": nodes_all[sel],
                        "E": _ladder_up(ne[sel].max()),
                        "F": _ladder_up(nf[sel].max())})
        return out


class GridView:
    """The grid arrays one shard gathers from (``DeviceGrid.on``): the
    copies on the shard's device, or the partitioned arrays themselves."""

    ARRAYS = ("esup2d", "esup_cnt", "fsup2d", "fsup_cnt", "esuf_pair",
              "point_coords", "centroids")

    def __init__(self, dgrid, shard):
        self.shard = shard
        self.device = dgrid.shards[shard]
        for name in self.ARRAYS:
            setattr(self, name, local(getattr(dgrid, name), self.device))
