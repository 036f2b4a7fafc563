"""Interpolator: public API facade.

Counterpart of ninpol_tpu/interpolator.py, API-compatible with the
reference orchestrator (ninpol/_interpolator/interpolator.pyx:35-670):

  * ``load_mesh(filename | mesh_obj)`` — mesh ingestion (built-in
    .msh/.vtk readers or meshio when available), heterogeneous cell blocks
    flattened into (n_elems, 8) padded connectivity, Grid build, data
    loading, transparent pickle cache in the system tempdir keyed on
    filename + file size (interpolator.pyx:93-166, 244-252).
  * ``interpolate(variable, method, target_points)`` — runs the method on
    the interpolator's torch device, or over a mesh of devices
    (parallel/sharding.py), and assembles the scipy CSR weight
    matrix of shape (n_target, n_elems) plus the Neumann vector
    (interpolator.pyx:549-629).  Matching the reference, the node's
    Neumann weight is ADDED to every CSR entry of its row
    (interpolator.pyx:618) and explicit zeros are eliminated.
  * ``load_data/load_cell_data/load_point_data/load_face_data`` and
    ``get_data/get_dict`` — named data-array management
    (interpolator.pyx:372-547).

Methods: "gls", "idw" and "ls", as in ninpol_tpu.

Deviation from the reference (documented): for target_points subsets the
reference indexes the weights buffer with global point ids and leaves
unfilled COO rows at -1, which crashes scipy (interpolator.pyx:612-618 vs
650); here subsets are handled correctly with rows numbered by target
position.  Full-target calls are bit-compatible.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time

import numpy as np
import scipy.sparse as sp
import torch

from ._grid.geometry import compute_diffusion_magnitude
from ._grid.grid import Grid
from ._io import mesh as meshio_compat
from ._methods.device_grid import DeviceGrid
from ._methods.gls import GLSInterpolation
from ._methods.idw import IDWInterpolation
from ._methods.ls import LSInterpolation
from .defines import (DTYPE_F, DTYPE_I, MAX_POINTS_PER_ELEMENT,
                      TYPES_PER_DIMENSION, TYPE_NAME_TO_INDEX,
                      build_type_tables)
from .parallel.sharding import as_mesh
from .utils.logger import Logger
from .utils.tracing import PREFIX, public, span


class Interpolator:

    def __init__(self, name="interpolator", logging=False, build_edges=False,
                 mesh=None, shard_geometry=False, device=None):
        """The parameters up to ``shard_geometry`` are ninpol_tpu's, in its
        order, so ``Interpolator("x", False, False, 2)`` is a two-device
        mesh in both packages; ``device`` follows them.

        ``mesh``: run every interpolation over several devices, as
        ``ninpol_tpu.Interpolator(mesh=...)`` does: an int (the first
        min(mesh, count) CUDA cards, ``parallel.make_mesh(mesh,
        device=device)``, which logs a shortfall and raises only where
        there is no card; with ``device="cpu"`` that many CPU shards), a
        sequence of devices (taken as given: ``["cuda:0", "cuda:0"]`` is
        two shards on one card; a card that does not exist raises) or a
        ``parallel.Mesh``.  One process
        drives every device: each stencil class's nodes are split evenly
        over the shards, each shard's chunks run on its device, and the
        results are copied to the mesh's first (primary) device, where
        ``prepare_interpolator(..., device_out=True)`` returns them.  The
        grid arrays are replicated on every device; with
        ``shard_geometry=True`` they are partitioned instead (row ranges
        on dim 0, padded to the mesh size; a stencil gather reads the
        parts on their owners' devices), for meshes whose geometry exceeds
        one device's memory.  The weights are those of one device, to
        1e-11.

        ``shard_geometry`` is dropped without a mesh, as ninpol_tpu drops
        it (``interp.shard_geometry`` is then False).  With a mesh it also
        picks ninpol_tpu's unfused shifted-CholeskyQR2 route for GLS (the
        route ``ninpol_tpu.Interpolator(mesh=N, shard_geometry=True)``
        takes): the gram, chol_linv, round2_gram and prec_apply kernels of
        ops/cholqr.py with float64 refinement sweeps, instead of the fused
        solve kernel.  ``interp.gls.fused = False`` takes that route on
        one device, the counterpart of ninpol_tpu's backend test
        (gls.py:1223), which sends every backend but the TPU down it.  The
        weights agree to the same 1e-10 bar.

        ``device``: the torch device the methods run on.  The default is
        the CUDA card; without one the first interpolation raises.  Pass
        ``device="cpu"`` to run on the CPU.  With a mesh it names only the
        mesh's device type.

        ``interp.delivery_f32 = True`` (ninpol_tpu's setting of that name,
        off by default) casts the delivered weights and Neumann vector to
        float32 on the device before the copy to the host, halving its
        bytes, at ~1e-7 relative rounding; the host arrays stay float64.
        ``prepare_interpolator(..., device_out=True)`` ignores it.

        ``interp.gls.solver = "pallas"`` selects ninpol_tpu's cross-check
        route of the same name, whatever ``shard_geometry`` says: a
        Householder R per node and the corrected semi-normal equations
        (the qr_r and sne_solve kernels of ops/qr.py), again to 1e-10.
        "auto" (the default) and "cholqr" keep the CholeskyQR2 routes;
        any other name runs ninpol_tpu's "refined" route (a float32
        Householder R of the equilibrated system as preconditioner and
        ``n_refine`` float64 refinement sweeps), again to 1e-10.
        ``interp.gls.precond_rounds = 1`` gives the fused solve kernel a
        single-round CholeskyQR preconditioner (two more sweeps), as
        ninpol_tpu's fused kernel has; the other routes ignore it."""
        self.is_grid_initialized = False
        self.build_edges = build_edges
        self.logging = logging
        self.logger = Logger(name, logging=logging)
        self.mesh = as_mesh(mesh, device)
        self.device = device if self.mesh is None else self.mesh.primary
        self.shard_geometry = bool(shard_geometry) and self.mesh is not None

        self.gls = GLSInterpolation(logging)
        self.gls.fused = not self.shard_geometry
        self.idw = IDWInterpolation(logging)
        self.ls = LSInterpolation(logging)
        self.supported_methods = {
            "gls": self.gls.prepare,
            "idw": self.idw.prepare,
            "ls": self.ls.prepare,
        }

        self.variable_to_index = {"points": {}, "cells": {}, "faces": {}}
        self.types_per_dimension = TYPES_PER_DIMENSION

        self.cells_data = np.zeros((1, 1), dtype=DTYPE_F)
        self.cells_data_dimensions = np.zeros(1, dtype=DTYPE_I)
        self.points_data = np.zeros((1, 1), dtype=DTYPE_F)
        self.points_data_dimensions = np.zeros(1, dtype=DTYPE_I)
        self.faces_data = np.zeros((1, 1), dtype=DTYPE_F)
        self.faces_data_dimensions = np.zeros(1, dtype=DTYPE_I)

        self.grid = None
        self.mesh_obj = None
        self.points_coords = None
        self._device_grid = None
        # prepared-weights cache: (method, variable, target-hash,
        # settings) -> (weights, neumann_ws); invalidated by any
        # load_mesh/load_data call
        self._prep_cache = {}
        # CSR pattern cache (rows/cols/mask derive from the grid only)
        self._csr_pattern = None
        # monotonic stamp bumped on every load_mesh/load_data: keys the
        # method-level device caches (id() of numpy arrays is unsafe —
        # CPython reuses addresses after GC)
        self._data_version = 0
        # float32 host delivery (ninpol_tpu's non-parity setting; the
        # 1e-10 parity contract needs the default False)
        self.delivery_f32 = False
        self.CACHE_PATH = tempfile.gettempdir()

    # ------------------------------------------------------------------
    # Cache (reference: interpolator.pyx:93-166)
    # ------------------------------------------------------------------
    def _cache_file(self, filename):
        # own prefix: ninpol_tpu's cache files pickle ninpol_tpu's Grid
        little_hash = hex(os.path.getsize(filename))
        base = os.path.basename(filename).split(".")[0]
        return os.path.join(self.CACHE_PATH,
                            f"ninpol_tpu_torch_{base}{little_hash}.pkl")

    def is_cached(self, filename):
        if filename == "":
            return None
        path = self._cache_file(filename)
        return path if os.path.exists(path) else None

    def _make_cache(self, args):
        return {
            "grid": args,
            "interpolator": {
                "cells_data": np.asarray(self.cells_data),
                "cells_data_dimensions": np.asarray(
                    self.cells_data_dimensions),
                "points_data": np.asarray(self.points_data),
                "points_data_dimensions": np.asarray(
                    self.points_data_dimensions),
                "faces_data": np.asarray(self.faces_data),
                "faces_data_dimensions": np.asarray(
                    self.faces_data_dimensions),
                "variable_to_index": self.variable_to_index,
                "points_coords": np.asarray(self.points_coords),
            },
        }

    def _load_cache(self, cache):
        self.grid = Grid(*cache["grid"])
        ic = cache["interpolator"]
        self.cells_data = ic["cells_data"]
        self.cells_data_dimensions = ic["cells_data_dimensions"]
        self.points_data = ic["points_data"]
        self.points_data_dimensions = ic["points_data_dimensions"]
        self.faces_data = ic["faces_data"]
        self.faces_data_dimensions = ic["faces_data_dimensions"]
        self.variable_to_index = ic["variable_to_index"]
        self.points_coords = ic["points_coords"]

    # ------------------------------------------------------------------
    # Mesh ingestion (reference: interpolator.pyx:168-369)
    # ------------------------------------------------------------------
    def load_mesh(self, filename="", mesh_obj=None):
        if filename == "" and mesh_obj is None:
            raise ValueError(
                "Filename for the mesh or meshio.Mesh object must be "
                "provided.")

        cached = self.is_cached(filename)
        args = None
        if cached:
            self.logger.log("Loading mesh from cache", "INFO")
            with open(cached, "rb") as f:
                self._load_cache(pickle.load(f))
        else:
            if filename != "":
                self.logger.log(f"Reading mesh from {filename}", "INFO")
                self.mesh_obj = meshio_compat.read(filename)
            else:
                self.logger.log("Using mesh object", "INFO")
                self.mesh_obj = meshio_compat.as_local_mesh(mesh_obj)
            args = self.process_mesh(self.mesh_obj)
            self.grid = Grid(*args)
            self.points_coords = np.asarray(
                self.mesh_obj.points, dtype=DTYPE_F)

        self._build_grid()
        if not cached:
            if self.mesh_obj.cell_data:
                self.load_cell_data()
            else:
                self.cells_data = np.zeros((1, 1), dtype=DTYPE_F)
                self.cells_data_dimensions = np.zeros(1, dtype=DTYPE_I)
            if self.mesh_obj.point_data:
                self.load_point_data()
            else:
                self.points_data = np.zeros((1, 1), dtype=DTYPE_F)
                self.points_data_dimensions = np.zeros(1, dtype=DTYPE_I)

        self.logger.log(
            f"Mesh loaded successfully: {self.grid.n_points} points and "
            f"{self.grid.n_elems} elements.", "INFO")

        if not cached and filename != "" and args is not None:
            with open(self._cache_file(filename), "wb") as f:
                pickle.dump(self._make_cache(args), f)

    def _build_grid(self):
        """Build topology + geometry of self.grid and reset every cache
        derived from the mesh."""
        t0 = time.perf_counter()
        self.grid.build()
        self.grid.load_point_coords(self.points_coords)
        self.grid.calculate_centroids()
        self.grid.calculate_normal_faces()
        self.logger.log(
            f"Grid built in {time.perf_counter() - t0:.2f} seconds", "INFO")
        self.is_grid_initialized = True
        self._device_grid = None
        self._prep_cache = {}
        self._csr_pattern = None
        self._data_version += 1

    def process_mesh(self, mesh):
        """Flatten heterogeneous cell blocks into padded connectivity
        (reference: interpolator.pyx:255-369)."""
        dim = 1
        for block in mesh.cells:
            for d, names in self.types_per_dimension.items():
                if block.type in names:
                    dim = max(dim, d)

        tables = build_type_tables(dim)

        n_points = mesh.points.shape[0]
        n_elems = sum(len(b) for b in mesh.cells
                      if b.type in self.types_per_dimension[dim])
        from ._grid.topology import hp_empty
        connectivity = hp_empty((n_elems, MAX_POINTS_PER_ELEMENT))
        connectivity.fill(-1)
        element_types = np.full(n_elems, -1, dtype=DTYPE_I)

        idx = 0
        for block in mesh.cells:
            if block.type not in self.types_per_dimension[dim]:
                continue
            t = TYPE_NAME_TO_INDEX[block.type]
            k = block.data.shape[1]
            connectivity[idx:idx + len(block), :k] = block.data
            element_types[idx:idx + len(block)] = t
            idx += len(block)

        return (dim, n_elems, n_points,
                tables["npoel"], tables["nfael"], tables["lnofa"],
                tables["lpofa"], tables["nedel"], tables["lpoed"],
                connectivity, element_types,
                self.logging, self.build_edges)

    # ------------------------------------------------------------------
    # Data loading (reference: interpolator.pyx:372-509)
    # ------------------------------------------------------------------
    @public
    def load_data(self, data_dict, data_type):
        with span(PREFIX + "load_data"):
            self._load_data(data_dict, data_type)

    def _load_data(self, data_dict, data_type):
        n_variables = len(data_dict)
        n_elements = (self.grid.n_elems if data_type == "cells"
                      else self.grid.n_points)
        dimensions = np.zeros(n_variables, dtype=DTYPE_I)
        max_shape = 1
        for index, variable in enumerate(data_dict):
            arr = np.asarray(data_dict[variable])
            cur = arr.shape[1] if arr.ndim > 1 else 1
            max_shape = max(max_shape, cur)
            self.variable_to_index[data_type][variable] = index
            dimensions[index] = cur

        data_array = np.zeros((n_variables, n_elements * max_shape),
                              dtype=DTYPE_F)
        for variable, arr in data_dict.items():
            self.logger.log(
                f"Loading {data_type} data for variable '{variable}'",
                "INFO")
            index = self.variable_to_index[data_type][variable]
            arr = np.asarray(arr, dtype=DTYPE_F)
            cur = int(dimensions[index])
            if cur == 1:
                flat = arr if arr.ndim == 1 else arr[:, 0]
                data_array[index, :n_elements] = flat
            else:
                data_array[index, :n_elements * cur] = arr[:, :cur].reshape(-1)

        if data_type == "cells":
            self.cells_data_dimensions = dimensions
            self.cells_data = data_array
        else:
            self.points_data_dimensions = dimensions
            self.points_data = data_array
        self._prep_cache = {}
        self._data_version += 1

    def load_cell_data(self):
        dim = self.grid.dim
        cell_data_dict = self.mesh_obj.cell_data_dict
        cell_data = {}
        for variable in cell_data_dict:
            parts = [np.asarray(arr)
                     for etype, arr in cell_data_dict[variable].items()
                     if etype in self.types_per_dimension[dim]]
            if not parts:
                continue
            cell_data[variable] = np.concatenate(parts, axis=0)
            if variable == "permeability":
                cell_data["diff_mag"] = np.asarray(
                    compute_diffusion_magnitude(cell_data["permeability"]))
        self.load_data(cell_data, "cells")

    def load_point_data(self):
        self.load_data(self.mesh_obj.point_data, "points")

    def load_face_data(self, data_dict, face_connectivity=None):
        """Load named face data (reference: interpolator.pyx:456-499).

        If ``face_connectivity`` is given, rows are matched against the
        grid's inpofa to build the face index mapping.
        """
        face_to_grid = np.arange(self.grid.n_faces, dtype=DTYPE_I)
        if face_connectivity is not None and len(face_connectivity) > 0:
            A = np.ascontiguousarray(face_connectivity, dtype=DTYPE_I)
            B = np.ascontiguousarray(self.grid.inpofa, dtype=DTYPE_I)
            A_view = A.view([("", A.dtype)] * A.shape[1]).ravel()
            B_view = B.view([("", B.dtype)] * B.shape[1]).ravel()
            idx_B_sorted = np.argsort(B_view)
            idx_in_B = np.searchsorted(B_view[idx_B_sorted], A_view)
            # validate: every user row must match a grid face exactly
            # (searchsorted silently returns neighbors for misses)
            idx_in_B = np.minimum(idx_in_B, len(B_view) - 1)
            matched = B_view[idx_B_sorted[idx_in_B]] == A_view
            if not matched.all():
                bad = int(np.nonzero(~matched)[0][0])
                raise ValueError(
                    f"face_connectivity row {bad} "
                    f"({np.asarray(A[bad]).tolist()}) does not match any "
                    "grid face (point ordering must follow the grid's "
                    "inpofa convention)")
            face_to_grid = idx_B_sorted[idx_in_B]

        self._prep_cache = {}
        self._data_version += 1
        self.faces_data = np.zeros((len(data_dict), self.grid.n_faces),
                                   dtype=DTYPE_F)
        self.faces_data_dimensions = np.zeros(len(data_dict), dtype=DTYPE_I)
        for i, (variable, arr) in enumerate(data_dict.items()):
            arr = np.asarray(arr, dtype=DTYPE_F).reshape(self.grid.n_faces,
                                                         -1)[:, 0]
            self.variable_to_index["faces"][variable] = i
            self.faces_data_dimensions[i] = 1
            # scatter: user row i describes grid face face_to_grid[i]
            self.faces_data[i, face_to_grid] = arr

    @public
    def compute_diffusion_magnitude(self, permeability):
        with span(PREFIX + "diff_mag"):
            return compute_diffusion_magnitude(permeability)

    # ------------------------------------------------------------------
    # Introspection (reference: interpolator.pyx:511-547)
    # ------------------------------------------------------------------
    def get_dict(self):
        from .defines import ELEMENT_SCHEMA
        return {
            "point_ordering": ELEMENT_SCHEMA,
            "variable_to_index": self.variable_to_index,
            "cells_data": np.asarray(self.cells_data),
            "cells_data_dimensions": np.asarray(self.cells_data_dimensions),
            "points_data": np.asarray(self.points_data),
            "points_data_dimensions": np.asarray(
                self.points_data_dimensions),
        }

    def get_data(self, data_type, index, variable):
        table = ("cells" if data_type == "cells" else "points")
        if variable not in self.variable_to_index[table]:
            raise ValueError(
                f"Variable '{variable}' not found in {table} data.")
        data_index = self.variable_to_index[table][variable]
        source = (self.cells_data if table == "cells" else self.points_data)
        return np.asarray(source[data_index])[np.asarray(index)]

    # ------------------------------------------------------------------
    # Interpolation (reference: interpolator.pyx:549-670)
    # ------------------------------------------------------------------
    @property
    def device_grid(self):
        if self._device_grid is None:
            self._device_grid = DeviceGrid(
                self.grid, mesh=self.mesh,
                shard_geometry=self.shard_geometry, device=self.device)
        return self._device_grid

    @public
    def interpolate(self, variable, method, target_points=None):
        if not self.is_grid_initialized:
            raise ValueError("Grid not initialized. Please load a mesh "
                             "first.")
        if method not in self.supported_methods:
            raise ValueError(
                f"Method '{method}' not supported. Supported methods are: "
                f"{list(self.supported_methods.keys())}")

        full_target = target_points is None or len(target_points) == 0
        if full_target:
            target_points = np.arange(self.grid.n_points, dtype=DTYPE_I)
        else:
            target_points = np.asarray(target_points, dtype=DTYPE_I)

        if variable not in self.variable_to_index["cells"]:
            raise ValueError(
                f"Variable '{variable}' not found in cells data. "
                "Point -> Cell interpolation not supported yet.")
        data_index = self.variable_to_index["cells"][variable]
        if self.cells_data_dimensions[data_index] > 1:
            raise ValueError(
                f"Variable '{variable}' has more than one dimension. "
                "Vector data not supported yet.")

        self.logger.log(
            f"Interpolating variable '{variable}' using method '{method}'",
            "INFO")
        tp_key = (method, variable, len(target_points),
                  hash(target_points.tobytes()),
                  self.gls.exact, self.gls.neumann_compat,
                  self.gls.n_refine, self.gls.fallback_tol, self.gls.fused,
                  self.gls.solver, self.gls.precond_rounds,
                  self.delivery_f32)
        if tp_key in self._prep_cache:
            weights, neumann_ws = self._prep_cache[tp_key]
        else:
            weights, neumann_ws = self.prepare_interpolator(
                method, variable, target_points)
            if len(self._prep_cache) >= 8:     # bounded: evict oldest
                self._prep_cache.pop(next(iter(self._prep_cache)))
            self._prep_cache[tp_key] = (weights, neumann_ws)
        with span(PREFIX + "csr_assembly"):
            return self._csr(weights, neumann_ws, target_points, full_target)

    def _csr(self, weights, neumann_ws, target_points, full_target):
        # CSR assembly (interpolator.pyx:594-629): per target node the
        # weight columns map to its esup entries; the node's Neumann weight
        # is ADDED to every entry of the row (interpolator.pyx:618).
        ptr = self.grid.esup_ptr
        if full_target and self._csr_pattern is not None:
            counts, cols, mask = self._csr_pattern
        else:
            counts = np.diff(ptr)[target_points]
            if full_target:
                cols = self.grid.esup
            else:
                cols = np.concatenate([
                    self.grid.esup[ptr[p]:ptr[p + 1]]
                    for p in target_points
                ]) if len(target_points) else np.zeros(0, dtype=DTYPE_I)
            cols = cols.astype(np.int32, copy=False)
            mask = (np.arange(weights.shape[1])[None, :] < counts[:, None])
            if full_target:
                self._csr_pattern = (counts, cols, mask)
        data = weights[mask] + np.repeat(neumann_ws, counts)

        # rows are sorted by construction (repeat of arange), so build
        # the CSR directly from (data, indices, indptr).  cols must be a
        # fresh copy: eliminate_zeros() compacts the indices array IN
        # PLACE, which would corrupt the cached pattern for the next call.
        indptr = np.zeros(len(target_points) + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        weights_sparse = sp.csr_matrix(
            (data, cols.copy(), indptr),
            shape=(len(target_points), self.grid.n_elems))
        weights_sparse.eliminate_zeros()
        return weights_sparse, np.asarray(neumann_ws)

    @public
    def prepare_interpolator(self, method, variable, target_points,
                             device_out=False):
        """Compute per-node weights.

        Default: fills and returns host arrays (weights, neumann_ws) —
        the reference contract (interpolator.pyx:631-670).

        device_out=True: returns the (n_target, n_cols+1) float64 torch
        tensor [weights | neumann_w] on the interpolator's device (a
        mesh's primary device), without the device->host copy (float64
        whatever ``delivery_f32`` says).
        """
        if method not in self.supported_methods:
            raise ValueError(
                f"Method '{method}' not supported. Supported methods are: "
                f"{list(self.supported_methods.keys())}")
        n_target = len(target_points)
        n_columns = self.grid.MX_ELEMENTS_PER_POINT
        weights = np.zeros((n_target, n_columns), dtype=DTYPE_F)
        neumann_ws = np.zeros(n_target, dtype=DTYPE_F)

        t0 = time.perf_counter()
        # content/version stamp for the GLS face-table cache
        self.gls._data_token = self._data_version
        for m in (self.gls, self.idw, self.ls):
            m.delivery_f32 = self.delivery_f32

        def run():
            return self.supported_methods[method](
                self.device_grid,
                self.cells_data, self.points_data, self.faces_data,
                self.variable_to_index, variable, target_points,
                weights, neumann_ws, device_out=device_out)

        trace_dir = os.environ.get("NINPOL_TPU_PROFILE", "")
        if trace_dir:
            # ninpol_tpu's device trace (jax.profiler.trace there): one
            # torch.profiler trace of this call, written into trace_dir as
            # a *.pt.trace.json that TensorBoard and Perfetto read; a
            # failure to write it raises
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.device("cuda" if self.device is None
                            else self.device).type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(
                    activities=activities,
                    on_trace_ready=torch.profiler.tensorboard_trace_handler(
                        trace_dir)):
                out = run()
        else:
            out = run()
        self.logger.log(
            f"Interpolation done in {time.perf_counter() - t0:.2f} seconds",
            "INFO")
        return out
