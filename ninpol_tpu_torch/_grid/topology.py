"""Vectorized host-side mesh-topology construction.

This replaces the reference's sequential/hash-based Cython topology engine
(reference: ninpol/_interpolator/grid.pyx:142-580) with sort-based NumPy
algorithms.  The outputs are *bit-identical in content and ordering* to the
reference structures, because every downstream consumer (weight column
ordering, face/boundary enumeration, GLS stencil assembly) depends on the
exact CSR orderings:

  esup   elements surrounding each point, CSR; per point the element ids are
         ascending because the reference fills them in element-major order
         (grid.pyx:233-267).
  psup   points surrounding each point, CSR, first-occurrence order over the
         element-major expansion (grid.pyx:269-302).
  infael element -> global face id (n_elems, 6); faces are numbered by first
         encounter in (element, local-face) lexicographic order
         (grid.pyx:304-345).
  inpofa face -> points (n_faces, 4), in the local lpofa ordering of the
         *defining* (lowest-id) element (grid.pyx:337-345, 424-432).
  esuel  element -> neighbor element across each local face (grid.pyx:449-525).
  fsup   faces surrounding each point, CSR, ascending face id
         (grid.pyx:347-379).
  esuf   elements surrounding each face, CSR, ascending element id
         (grid.pyx:381-416).
  boundary_faces / boundary_points flags (grid.pyx:434-444).
  inedel/inpoed optional edge structures, numbered by first encounter
         (grid.pyx:527-580; the reference's 64-bit-hash dedup is replaced by
         exact sort-based dedup, identical absent hash collisions).

An optional C++ fast path is provided by ninpol_tpu_torch.native (same contract);
this module is the portable fallback and the correctness oracle.
"""
from __future__ import annotations

import numpy as np

from ..defines import (DTYPE_F, DTYPE_I, MAX_EDGES_PER_ELEMENT,
                       MAX_FACES_PER_ELEMENT, MAX_POINTS_PER_EDGE,
                       MAX_POINTS_PER_FACE)
from .. import native


def _c(a):
    return np.ascontiguousarray(a, dtype=DTYPE_I)


def hp_empty(shape, dtype=DTYPE_I):
    """np.empty over an anonymous mmap with MADV_HUGEPAGE.

    This environment (a microVM) faults fresh 4 KB pages at as little
    as ~30 MB/s under host pressure, so first-touch of the ~0.5 GB of
    topology outputs can dominate a 2M-cell grid build; transparent
    huge pages (madvise mode here) cut the fault count 512x.  Falls
    back to plain np.empty for small arrays or where madvise is
    unavailable.  Anonymous mmap memory is zero-filled, so this also
    serves as a zeros() allocator."""
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if nbytes < (8 << 20):
        return np.empty(shape, dtype)
    import mmap
    try:
        mm = mmap.mmap(-1, nbytes)
        mm.madvise(mmap.MADV_HUGEPAGE)
    except (AttributeError, OSError, ValueError):
        return np.empty(shape, dtype)
    return np.frombuffer(mm, dtype=dtype).reshape(shape)


def _csr_from_pairs(owners, values, n_owners):
    """Build CSR (ptr, data) grouping ``values`` by ``owners``.

    Stable sort keeps the original encounter order within each owner group,
    which is exactly the reference's fill order.
    """
    order = np.argsort(owners, kind="stable")
    data = values[order]
    counts = np.bincount(owners, minlength=n_owners)
    ptr = np.zeros(n_owners + 1, dtype=DTYPE_I)
    np.cumsum(counts, out=ptr[1:])
    return ptr, data.astype(DTYPE_I, copy=False)


def build_esup(connectivity, element_types, npoel, n_points):
    """Elements-surrounding-point CSR (reference: grid.pyx:233-267)."""
    n_elems = connectivity.shape[0]
    if native.available():
        total = int(npoel[element_types].sum())
        ptr = np.zeros(n_points + 1, dtype=DTYPE_I)
        data = np.zeros(total, dtype=DTYPE_I)
        native.lib().build_esup(
            n_elems, n_points, connectivity.shape[1],
            _c(connectivity), _c(element_types), _c(npoel), ptr, data)
        return ptr, data
    valid = connectivity >= 0
    # Only the first npoel[type] slots are valid per the reference loop;
    # for well-formed meshes that equals the -1 padding mask.
    counts_per_elem = npoel[element_types]
    slot = np.arange(connectivity.shape[1])[None, :]
    valid &= slot < counts_per_elem[:, None]

    elems = np.broadcast_to(
        np.arange(n_elems, dtype=DTYPE_I)[:, None], connectivity.shape)[valid]
    points = connectivity[valid]
    ptr, data = _csr_from_pairs(points, elems, n_points)
    return ptr, data


def build_psup(esup_ptr, esup, connectivity, element_types, npoel, n_points):
    """Points-surrounding-point CSR, first-occurrence dedup order
    (reference: grid.pyx:269-302)."""
    if native.available():
        cap = int(len(esup)) * (connectivity.shape[1] - 1) + 1
        ptr = np.zeros(n_points + 1, dtype=DTYPE_I)
        data = np.zeros(cap, dtype=DTYPE_I)
        total = native.lib().build_psup(
            connectivity.shape[0], n_points, connectivity.shape[1],
            _c(connectivity), _c(element_types), _c(npoel),
            _c(esup_ptr), _c(esup), ptr, data)
        # view, not copy: the tail past `total` was never touched
        # (calloc pages — virtual only); see build_faces
        return ptr, data[:total]
    # Expand: for each (point i, esup slot) -> all points of that element.
    reps = npoel[element_types[esup]]                    # pts per esup entry
    own_per_entry = np.repeat(
        np.arange(n_points, dtype=DTYPE_I),
        np.diff(esup_ptr))                               # owner per esup entry
    own = np.repeat(own_per_entry, reps)
    # neighbor points: take the valid slots of each esup element
    conn_sel = connectivity[esup]                        # (n_entries, 8)
    slot = np.arange(conn_sel.shape[1])[None, :]
    mask = slot < reps[:, None]
    nbr = conn_sel[mask]
    pos = np.arange(own.shape[0], dtype=DTYPE_I)         # encounter order

    keep = nbr != own
    own, nbr, pos = own[keep], nbr[keep], pos[keep]

    # Dedup (own, nbr) keeping earliest pos.
    key = own * np.int64(n_points) + nbr
    order = np.lexsort((pos, key))
    key_s, own_s, nbr_s, pos_s = key[order], own[order], nbr[order], pos[order]
    first = np.ones(len(key_s), dtype=bool)
    first[1:] = key_s[1:] != key_s[:-1]
    own_u, nbr_u, pos_u = own_s[first], nbr_s[first], pos_s[first]

    # Restore per-owner encounter order.
    order2 = np.lexsort((pos_u, own_u))
    ptr, data = _csr_from_pairs(own_u[order2], nbr_u[order2], n_points)
    return ptr, data


def _face_keys(face_points, n_points):
    """Two-int64 canonical key for up-to-4-point faces (sorted points)."""
    srt = np.sort(face_points, axis=1)          # -1 padding sorts first
    base = np.int64(n_points + 2)
    k1 = (srt[:, 0] + 1) * base + (srt[:, 1] + 1)
    if face_points.shape[1] > 2:
        k2 = (srt[:, 2] + 1) * base + (srt[:, 3] + 1)
    else:
        k2 = np.zeros_like(k1)
    return k1, k2


def build_faces(connectivity, element_types, nfael, lnofa, lpofa, n_points):
    """Enumerate unique faces; build infael, inpofa, esuel, boundary flags.

    Reproduces the reference numbering: face ids are assigned by first
    encounter in (element, local-face-slot) order (grid.pyx:304-345), and
    inpofa holds the defining element's local point ordering.
    """
    n_elems = connectivity.shape[0]
    F = MAX_FACES_PER_ELEMENT
    if native.available():
        # n_faces can never exceed the half-face count (each unique face
        # is defined by one half-face) — at 1.9M tets this caps inpofa
        # at 241 MB instead of 363 MB, and fresh-page faults on these
        # allocations dominate the build, not the hash walk itself
        cap = int(nfael[element_types].sum())
        infael = hp_empty((n_elems, F))
        inpofa = hp_empty((cap, MAX_POINTS_PER_FACE))
        esuel = hp_empty((n_elems, F))
        bfaces = np.zeros(cap, dtype=DTYPE_I)  # flags: only [:n_faces] read
        bpoints = np.zeros(n_points, dtype=DTYPE_I)
        n_faces = native.lib().build_faces(
            n_elems, n_points, connectivity.shape[1],
            _c(connectivity), _c(element_types), _c(nfael),
            _c(lnofa), _c(lpofa), F, MAX_POINTS_PER_FACE,
            infael, inpofa, esuel, bfaces, bpoints)
        if n_faces == -2:
            raise MemoryError("native build_faces: table allocation failed")
        if n_faces < 0:
            raise ValueError(
                "Non-manifold mesh: a face is shared by more than "
                "2 elements.")
        # VIEWS, not copies: the buffer tails beyond n_faces were never
        # touched, so they are virtual-only (no resident pages) — while
        # a .copy() allocates fresh pages, and first-touch faults cost
        # up to ~340 us/page here (the two copies measured 1.3 s at
        # 1.9M tets).
        return {
            "n_faces": int(n_faces),
            "infael": infael,
            "inpofa": inpofa[:n_faces],
            "esuel": esuel,
            "boundary_faces": bfaces[:n_faces],
            "boundary_points": bpoints,
        }

    etypes = element_types
    valid = (np.arange(F)[None, :] < nfael[etypes][:, None])  # (E, F)

    # Gather face points for every (elem, slot): (E, F, 4)
    lp = lpofa[etypes]                                   # (E, F, 4)
    fp = np.where(lp >= 0, np.take_along_axis(
        np.broadcast_to(connectivity[:, None, :],
                        (n_elems, F, connectivity.shape[1])),
        np.clip(lp, 0, None), axis=2), -1)

    flat_valid = valid.reshape(-1)
    fp_flat = fp.reshape(-1, MAX_POINTS_PER_FACE)[flat_valid]
    elem_of = np.broadcast_to(
        np.arange(n_elems, dtype=DTYPE_I)[:, None], (n_elems, F)
    ).reshape(-1)[flat_valid]
    slot_of = np.broadcast_to(
        np.arange(F, dtype=DTYPE_I)[None, :], (n_elems, F)
    ).reshape(-1)[flat_valid]
    flat_idx = np.arange(fp_flat.shape[0], dtype=DTYPE_I)  # encounter order

    k1, k2 = _face_keys(fp_flat, n_points)
    order = np.lexsort((flat_idx, k2, k1))
    k1s, k2s = k1[order], k2[order]
    newgrp = np.ones(len(order), dtype=bool)
    newgrp[1:] = (k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1])
    grp_of_sorted = np.cumsum(newgrp) - 1                # group id per sorted
    n_groups = grp_of_sorted[-1] + 1 if len(order) else 0

    # First (encounter-order) member of each group defines the face.
    first_sorted_pos = np.nonzero(newgrp)[0]
    definer_flat = order[first_sorted_pos]               # flat idx of definer
    # Face numbering = rank of definer encounter order.
    face_rank = np.empty(n_groups, dtype=DTYPE_I)
    face_rank[np.argsort(definer_flat, kind="stable")] = np.arange(
        n_groups, dtype=DTYPE_I)

    grp_of_flat = np.empty(len(order), dtype=DTYPE_I)
    grp_of_flat[order] = grp_of_sorted
    face_of_flat = face_rank[grp_of_flat]                # face id per halfface

    infael = np.full((n_elems, F), -1, dtype=DTYPE_I)
    infael[elem_of, slot_of] = face_of_flat

    n_faces = int(n_groups)
    inpofa = np.full((n_faces, MAX_POINTS_PER_FACE), -1, dtype=DTYPE_I)
    inpofa[face_of_flat[definer_flat]] = fp_flat[definer_flat]

    # esuel: the other member of a 2-member group.
    grp_sizes = np.bincount(grp_of_sorted, minlength=n_groups)
    if grp_sizes.max(initial=0) > 2:
        raise ValueError(
            "Non-manifold mesh: a face is shared by more than 2 elements.")
    esuel = np.full((n_elems, F), -1, dtype=DTYPE_I)
    pair_groups = np.nonzero(grp_sizes == 2)[0]
    if len(pair_groups):
        # within sorted order, members of a 2-group are adjacent
        pos_first = first_sorted_pos[pair_groups]
        a = order[pos_first]
        b = order[pos_first + 1]
        esuel[elem_of[a], slot_of[a]] = elem_of[b]
        esuel[elem_of[b], slot_of[b]] = elem_of[a]

    # Boundary faces: groups of size 1.
    boundary_faces = np.zeros(n_faces, dtype=DTYPE_I)
    single_groups = np.nonzero(grp_sizes == 1)[0]
    boundary_faces[face_rank[single_groups]] = 1
    boundary_points = np.zeros(n_points, dtype=DTYPE_I)
    bpts = inpofa[boundary_faces.astype(bool)]
    bpts = bpts[bpts >= 0]
    boundary_points[bpts] = 1

    return {
        "n_faces": n_faces,
        "infael": infael,
        "inpofa": inpofa,
        "esuel": esuel,
        "boundary_faces": boundary_faces,
        "boundary_points": boundary_points,
    }


def build_fsup(inpofa, n_points):
    """Faces-surrounding-point CSR (reference: grid.pyx:347-379)."""
    n_faces = inpofa.shape[0]
    if native.available():
        total = int((inpofa >= 0).sum())
        ptr = np.zeros(n_points + 1, dtype=DTYPE_I)
        data = np.zeros(total, dtype=DTYPE_I)
        native.lib().build_fsup(n_faces, n_points, _c(inpofa), ptr, data)
        return ptr, data
    valid = inpofa >= 0
    faces = np.broadcast_to(
        np.arange(n_faces, dtype=DTYPE_I)[:, None], inpofa.shape)[valid]
    points = inpofa[valid]
    return _csr_from_pairs(points, faces, n_points)


def build_esuf(infael, element_types, nfael, n_faces):
    """Elements-surrounding-face CSR (reference: grid.pyx:381-416)."""
    n_elems = infael.shape[0]
    if native.available():
        total = int(nfael[element_types].sum())
        ptr = np.zeros(n_faces + 1, dtype=DTYPE_I)
        data = np.zeros(total, dtype=DTYPE_I)
        native.lib().build_esuf(
            n_elems, n_faces, infael.shape[1],
            _c(infael), _c(element_types), _c(nfael), ptr, data)
        return ptr, data
    valid = (np.arange(infael.shape[1])[None, :] <
             nfael[element_types][:, None]) & (infael >= 0)
    elems = np.broadcast_to(
        np.arange(n_elems, dtype=DTYPE_I)[:, None], infael.shape)[valid]
    faces = infael[valid]
    return _csr_from_pairs(faces, elems, n_faces)


def build_edges(connectivity, element_types, nedel, lpoed, n_points):
    """Unique-edge enumeration (reference: grid.pyx:527-580).

    Edge ids are assigned by first encounter in (element, local-edge) order;
    inpoed stores the first encounter's *original* orientation.  The
    reference dedups via a 64-bit hash of the sorted pair — exact sort-based
    dedup is identical in the absence of hash collisions.
    """
    n_elems = connectivity.shape[0]
    Emax = MAX_EDGES_PER_ELEMENT
    if native.available():
        cap = n_elems * Emax
        inedel = np.empty((n_elems, Emax), dtype=DTYPE_I)
        inpoed = np.empty((cap, MAX_POINTS_PER_EDGE), dtype=DTYPE_I)
        n_edges = native.lib().build_edges(
            n_elems, n_points, connectivity.shape[1],
            _c(connectivity), _c(element_types), _c(nedel), _c(lpoed),
            Emax, inedel, inpoed)
        return {"n_edges": int(n_edges), "inedel": inedel,
                "inpoed": inpoed[:n_edges].copy()}
    etypes = element_types
    valid = np.arange(Emax)[None, :] < nedel[etypes][:, None]

    lp = lpoed[etypes]                                   # (E, 12, 2)
    ep = np.where(lp >= 0, np.take_along_axis(
        np.broadcast_to(connectivity[:, None, :],
                        (n_elems, Emax, connectivity.shape[1])),
        np.clip(lp, 0, None), axis=2), -1)

    flat_valid = valid.reshape(-1)
    ep_flat = ep.reshape(-1, MAX_POINTS_PER_EDGE)[flat_valid]
    elem_of = np.broadcast_to(
        np.arange(n_elems, dtype=DTYPE_I)[:, None], (n_elems, Emax)
    ).reshape(-1)[flat_valid]
    slot_of = np.broadcast_to(
        np.arange(Emax, dtype=DTYPE_I)[None, :], (n_elems, Emax)
    ).reshape(-1)[flat_valid]
    flat_idx = np.arange(ep_flat.shape[0], dtype=DTYPE_I)

    srt = np.sort(ep_flat, axis=1)
    key = (srt[:, 0] + 1) * np.int64(n_points + 2) + (srt[:, 1] + 1)
    order = np.lexsort((flat_idx, key))
    key_s = key[order]
    newgrp = np.ones(len(order), dtype=bool)
    newgrp[1:] = key_s[1:] != key_s[:-1]
    grp_of_sorted = np.cumsum(newgrp) - 1
    n_groups = int(grp_of_sorted[-1] + 1) if len(order) else 0

    first_sorted_pos = np.nonzero(newgrp)[0]
    definer_flat = order[first_sorted_pos]
    edge_rank = np.empty(n_groups, dtype=DTYPE_I)
    edge_rank[np.argsort(definer_flat, kind="stable")] = np.arange(
        n_groups, dtype=DTYPE_I)

    grp_of_flat = np.empty(len(order), dtype=DTYPE_I)
    grp_of_flat[order] = grp_of_sorted
    edge_of_flat = edge_rank[grp_of_flat]

    inedel = np.full((n_elems, Emax), -1, dtype=DTYPE_I)
    inedel[elem_of, slot_of] = edge_of_flat
    inpoed = np.full((n_groups, MAX_POINTS_PER_EDGE), -1, dtype=DTYPE_I)
    inpoed[edge_of_flat[definer_flat]] = ep_flat[definer_flat]

    return {"n_edges": n_groups, "inedel": inedel, "inpoed": inpoed}


def csr_to_padded(ptr, data, width=None, fill=-1):
    """Convert CSR (ptr, data) to a padded 2D array (reference:
    grid.pyx:626-652 does the same for get_data())."""
    counts = np.diff(ptr)
    n = len(counts)
    if width is None:
        width = int(counts.max(initial=0))
    out = np.full((n, width), fill, dtype=data.dtype)
    if len(data):
        cols = np.arange(len(data)) - np.repeat(ptr[:-1], counts)
        rows = np.repeat(np.arange(n), counts)
        out[rows, cols] = data
    return out
