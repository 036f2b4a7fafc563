"""Grid: unstructured-mesh topology + geometry container.

API-compatible rebuild of the reference's ``Grid`` extension type
(reference: ninpol/_interpolator/grid.pyx:46-809, attribute documentation in
grid.pxd:23-121).  The constructor signature, attribute names, CSR layouts
and ``get_data()`` dictionary match the reference so downstream code and
tests can swap implementations.

The heavy lifting lives in :mod:`ninpol_tpu_torch._grid.topology` (vectorized
sort-based construction, optionally accelerated by the C++ native module)
and :mod:`ninpol_tpu_torch._grid.geometry`.
"""
from __future__ import annotations

import time

import numpy as np

from ..defines import (DTYPE_F, DTYPE_I, MAX_EDGES_PER_ELEMENT,
                       MAX_FACES_PER_ELEMENT, MAX_POINTS_PER_EDGE,
                       MAX_POINTS_PER_ELEMENT, MAX_POINTS_PER_FACE,
                       NUM_ELEMENT_TYPES)
from ..utils.logger import Logger
from . import geometry, topology


class Grid:
    """Mesh topology/geometry engine (reference: grid.pyx:46-140)."""

    def __init__(self, dim, n_elems, n_points,
                 npoel, nfael, lnofa, lpofa, nedel, lpoed,
                 connectivity, element_types,
                 logging=False, build_edges=False):
        if dim < 1:
            raise ValueError("The number of dimensions must be greater than 0.")
        if n_elems < 1:
            raise ValueError("The number of elements must be greater than 0.")
        if n_points < 1:
            raise ValueError("The number of points must be greater than 0.")

        self.dim = int(dim)
        self.n_elems = int(n_elems)
        self.n_points = int(n_points)
        self.n_faces = 0
        self.n_edges = 0

        self.MX_ELEMENTS_PER_POINT = 0
        self.MX_POINTS_PER_POINT = 0
        self.MX_ELEMENTS_PER_FACE = 0
        self.MX_FACES_PER_POINT = 0

        self.logging = bool(logging)
        self.logger = Logger("Grid", logging=self.logging)
        self.build_edges = bool(build_edges)

        def _validated(array, expected_shape):
            array = np.ascontiguousarray(array, dtype=DTYPE_I)
            if array.shape != expected_shape:
                raise ValueError(
                    f"The array must have shape {expected_shape}, "
                    f"not {array.shape}.")
            return array.copy()

        T = NUM_ELEMENT_TYPES
        self.npoel = _validated(npoel, (T,))
        self.nfael = _validated(nfael, (T,))
        self.lnofa = _validated(lnofa, (T, MAX_FACES_PER_ELEMENT))
        self.lpofa = _validated(
            lpofa, (T, MAX_FACES_PER_ELEMENT, MAX_POINTS_PER_FACE))
        self.nedel = _validated(nedel, (T,))
        self.lpoed = _validated(
            lpoed, (T, MAX_EDGES_PER_ELEMENT, MAX_POINTS_PER_EDGE))

        # no defensive copy: process_mesh/_load_cache hand over freshly
        # built arrays, and Grid never mutates these (the ctor copy pass
        # cost ~1s at 1M cells)
        self.inpoel = np.ascontiguousarray(connectivity, dtype=DTYPE_I)
        self.element_types = np.ascontiguousarray(
            element_types, dtype=DTYPE_I)

        self.are_elements_loaded = True
        self.are_coords_loaded = False
        self.are_structures_built = False
        self.are_centroids_calculated = False
        self.are_normals_calculated = False

        z_i = np.zeros(0, dtype=DTYPE_I)
        z_i2 = np.zeros((0, 0), dtype=DTYPE_I)
        z_f2 = np.zeros((0, 0), dtype=DTYPE_F)
        self.boundary_faces = z_i.copy()
        self.boundary_points = z_i.copy()
        self.esup = z_i.copy()
        self.esup_ptr = z_i.copy()
        self.psup = z_i.copy()
        self.psup_ptr = z_i.copy()
        self.inpofa = z_i2.copy()
        self.infael = z_i2.copy()
        self.esuf = z_i.copy()
        self.esuf_ptr = z_i.copy()
        self.fsup = z_i.copy()
        self.fsup_ptr = z_i.copy()
        self.esuel = z_i2.copy()
        self.inpoed = z_i2.copy()
        self.inedel = z_i2.copy()
        self.point_coords = z_f2.copy()
        self.centroids = z_f2.copy()
        self.faces_centers = z_f2.copy()
        self.faces_areas = np.zeros(0, dtype=DTYPE_F)
        self.normal_faces = z_f2.copy()

    # ------------------------------------------------------------------
    # Topology (reference: grid.pyx:142-231)
    # ------------------------------------------------------------------
    def build(self):
        t0 = time.perf_counter()
        self.esup_ptr, self.esup = topology.build_esup(
            self.inpoel, self.element_types, self.npoel, self.n_points)
        counts = np.diff(self.esup_ptr)
        self.MX_ELEMENTS_PER_POINT = int(counts.max(initial=0))
        self._log_phase("build esup", t0)

        t0 = time.perf_counter()
        self.psup_ptr, self.psup = topology.build_psup(
            self.esup_ptr, self.esup, self.inpoel, self.element_types,
            self.npoel, self.n_points)
        self.MX_POINTS_PER_POINT = int(np.diff(self.psup_ptr).max(initial=0))
        self._log_phase("build_psup", t0)

        t0 = time.perf_counter()
        faces = topology.build_faces(
            self.inpoel, self.element_types, self.nfael, self.lnofa,
            self.lpofa, self.n_points)
        self.n_faces = faces["n_faces"]
        self.infael = faces["infael"]
        self.inpofa = faces["inpofa"]
        self.esuel = faces["esuel"]
        self.boundary_faces = faces["boundary_faces"]
        self.boundary_points = faces["boundary_points"]
        self._log_phase("build faces/esuel", t0)

        t0 = time.perf_counter()
        self.fsup_ptr, self.fsup = topology.build_fsup(
            self.inpofa, self.n_points)
        self.MX_FACES_PER_POINT = int(np.diff(self.fsup_ptr).max(initial=0))
        self._log_phase("build_fsup", t0)

        t0 = time.perf_counter()
        self.esuf_ptr, self.esuf = topology.build_esuf(
            self.infael, self.element_types, self.nfael, self.n_faces)
        self.MX_ELEMENTS_PER_FACE = int(np.diff(self.esuf_ptr).max(initial=0))
        self._log_phase("build esuf", t0)

        if self.build_edges:
            self.logger.log("Grid will build edge data.", "INFO")
            t0 = time.perf_counter()
            edges = topology.build_edges(
                self.inpoel, self.element_types, self.nedel, self.lpoed,
                self.n_points)
            self.n_edges = edges["n_edges"]
            self.inedel = edges["inedel"]
            self.inpoed = edges["inpoed"]
            self._log_phase("build_inedel", t0)
        else:
            self.logger.log("Grid will not build edge data.", "INFO")

        self.are_structures_built = True

    def _log_phase(self, name, t0):
        self.logger.log(
            f"Time to {name:<15}: {time.perf_counter() - t0:.3f} s", "INFO")

    # ------------------------------------------------------------------
    # Geometry (reference: grid.pyx:661-809)
    # ------------------------------------------------------------------
    def load_point_coords(self, coords):
        coords = np.ascontiguousarray(coords, dtype=DTYPE_F)
        if coords.shape[1] != 3:
            padded = np.zeros((coords.shape[0], 3), dtype=DTYPE_F)
            padded[:, :coords.shape[1]] = coords
            coords = padded
        self.point_coords = coords
        self.are_coords_loaded = True

    def calculate_centroids(self):
        if not self.are_elements_loaded:
            raise ValueError("The element types have not been set.")
        if not self.are_coords_loaded:
            raise ValueError("The point coordinates have not been set.")
        self.centroids = geometry.calculate_centroids(
            self.point_coords, self.inpoel, self.element_types, self.npoel,
            self.dim)
        fg = geometry._face_geometry_native(
            self.point_coords, self.inpofa, self.dim)
        if fg is not None:
            # one native pass fills centers+normals+areas; stash the
            # normals for calculate_normal_faces
            self.faces_centers, self._fg_normals, self._fg_areas = fg
        else:
            self._fg_normals = None
            self.faces_centers = geometry.calculate_face_centers(
                self.point_coords, self.inpofa, self.dim)
        self.are_centroids_calculated = True

    def calculate_normal_faces(self, precise=False):
        if not precise and getattr(self, "_fg_normals", None) is not None:
            self.normal_faces = self._fg_normals
            self.faces_areas = self._fg_areas
        else:
            self.normal_faces, self.faces_areas = geometry.calculate_normals(
                self.point_coords, self.inpofa, self.dim, precise=precise)
        self.are_normals_calculated = True

    # ------------------------------------------------------------------
    # Export (reference: grid.pyx:583-658)
    # ------------------------------------------------------------------
    def get_data(self):
        import warnings
        if not self.are_coords_loaded:
            warnings.warn("The point coordinates have not been set.")
        if not self.are_structures_built:
            raise ValueError("The structures have not been built.")
        if not self.are_centroids_calculated:
            warnings.warn("The centroids have not been calculated.")

        data = {
            "n_elems": self.n_elems,
            "n_points": self.n_points,
            "n_faces": self.n_faces,
            "n_edges": self.n_edges,
            "MX_ELEMENTS_PER_POINT": self.MX_ELEMENTS_PER_POINT,
            "MX_POINTS_PER_POINT": self.MX_POINTS_PER_POINT,
            "MX_ELEMENTS_PER_FACE": self.MX_ELEMENTS_PER_FACE,
            "MX_FACES_PER_POINT": self.MX_FACES_PER_POINT,
            "point_coords": self.point_coords.copy(),
            "centroids": self.centroids.copy(),
            "normal_faces": self.normal_faces.copy(),
            "faces_centers": self.faces_centers.copy(),
            "faces_areas": self.faces_areas.copy(),
            "boundary_faces": self.boundary_faces.copy(),
            "boundary_points": self.boundary_points.copy(),
            "inpoel": self.inpoel.copy(),
            "element_types": self.element_types.copy(),
            "inpofa": self.inpofa.copy(),
            "infael": self.infael.copy(),
            "inpoed": self.inpoed.copy(),
            "inedel": self.inedel.copy(),
            "esup": topology.csr_to_padded(
                self.esup_ptr, self.esup, self.MX_ELEMENTS_PER_POINT),
            "psup": topology.csr_to_padded(
                self.psup_ptr, self.psup, self.MX_POINTS_PER_POINT),
            "esuf": topology.csr_to_padded(
                self.esuf_ptr, self.esuf, self.MX_ELEMENTS_PER_FACE),
            "fsup": topology.csr_to_padded(
                self.fsup_ptr, self.fsup, self.MX_FACES_PER_POINT),
        }
        return data
