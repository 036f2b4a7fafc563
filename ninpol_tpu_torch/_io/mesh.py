"""Minimal meshio-compatible mesh container and file I/O.

The reference delegates all mesh-format parsing to the external ``meshio``
package (reference: ninpol/_interpolator/interpolator.pyx:188, setup.py:124).
That package is not available in this environment, so this module provides:

  * :class:`CellBlock` / :class:`Mesh` — duck-typed stand-ins exposing the
    subset of the meshio API the framework and its tests use
    (``points``, ``cells``, ``cells_dict``, ``cell_data``, ``cell_data_dict``,
    ``point_data``).
  * :func:`read` — parsers for Gmsh ``.msh`` (ASCII v2.2 / v4.1) and legacy
    VTK ``.vtk`` (ASCII unstructured grid), the formats used by the
    reference's test meshes (tests/mesh/*.msh, *.vtk).
  * :func:`write` — matching ASCII writers.

If a real ``meshio`` is importable it is preferred transparently (see
:func:`read`), so user code keeps working with either.
"""
from __future__ import annotations

import numpy as np

try:  # pragma: no cover - exercised only when meshio is installed
    import meshio as _meshio
except ImportError:  # pragma: no cover
    _meshio = None

# Gmsh element-type ids -> (meshio type name, nodes per element)
_GMSH_TYPES = {
    15: ("vertex", 1),
    1: ("line", 2),
    2: ("triangle", 3),
    3: ("quad", 4),
    4: ("tetra", 4),
    5: ("hexahedron", 8),
    6: ("wedge", 6),
    7: ("pyramid", 5),
}
_GMSH_TYPE_IDS = {v[0]: k for k, v in _GMSH_TYPES.items()}

# VTK cell-type ids -> (meshio type name, nodes per element)
_VTK_TYPES = {
    1: ("vertex", 1),
    3: ("line", 2),
    5: ("triangle", 3),
    9: ("quad", 4),
    10: ("tetra", 4),
    12: ("hexahedron", 8),
    13: ("wedge", 6),
    14: ("pyramid", 5),
}
_VTK_TYPE_IDS = {v[0]: k for k, v in _VTK_TYPES.items()}


class CellBlock:
    """One homogeneous block of cells (mirrors meshio.CellBlock)."""

    def __init__(self, cell_type: str, data):
        self.type = cell_type
        self.data = np.asarray(data, dtype=np.int64)

    def __len__(self):
        return len(self.data)

    def __iter__(self):
        return iter((self.type, self.data))

    def __repr__(self):
        return f"<CellBlock {self.type}: {len(self.data)} cells>"


class Mesh:
    """Duck-typed meshio.Mesh replacement."""

    def __init__(self, points, cells, point_data=None, cell_data=None):
        self.points = np.asarray(points, dtype=np.float64)
        norm_cells = []
        for block in cells:
            if isinstance(block, CellBlock):
                norm_cells.append(block)
            elif hasattr(block, "type") and hasattr(block, "data"):
                # meshio's CellBlock, or another package's copy of ours
                norm_cells.append(CellBlock(block.type, block.data))
            else:  # (type, data) tuple
                norm_cells.append(CellBlock(block[0], block[1]))
        self.cells = norm_cells
        self.point_data = dict(point_data or {})
        # cell_data: {var: [array_per_block, ...]} (meshio convention)
        self.cell_data = {
            k: [np.asarray(b) for b in v] for k, v in (cell_data or {}).items()
        }

    @property
    def cells_dict(self):
        out = {}
        for block in self.cells:
            if block.type in out:
                out[block.type] = np.concatenate(
                    [out[block.type], block.data], axis=0)
            else:
                out[block.type] = block.data
        return out

    @property
    def cell_data_dict(self):
        """{var: {cell_type: concatenated array}} (meshio convention)."""
        out = {}
        for var, blocks in self.cell_data.items():
            per_type = {}
            for block, arr in zip(self.cells, blocks):
                if block.type in per_type:
                    per_type[block.type] = np.concatenate(
                        [per_type[block.type], np.asarray(arr)], axis=0)
                else:
                    per_type[block.type] = np.asarray(arr)
            out[var] = per_type
        return out

    def __repr__(self):
        parts = ", ".join(f"{b.type}:{len(b)}" for b in self.cells)
        return f"<Mesh {len(self.points)} points, [{parts}]>"


def as_local_mesh(mesh) -> Mesh:
    """Normalize any meshio-like object into a local :class:`Mesh`."""
    if isinstance(mesh, Mesh):
        return mesh
    cell_data = getattr(mesh, "cell_data", {}) or {}
    return Mesh(mesh.points, mesh.cells, getattr(mesh, "point_data", {}),
                cell_data)


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

def read(filename: str) -> Mesh:
    """Read a mesh file. Prefers real meshio when installed.

    Built-in readers: Gmsh .msh v2.2 and v4.1 (ASCII and binary),
    legacy VTK unstructured grid (ASCII and binary).
    """
    if _meshio is not None:
        return as_local_mesh(_meshio.read(filename))
    name = str(filename).lower()
    if name.endswith(".msh"):
        return _read_gmsh(filename)
    if name.endswith(".vtk"):
        return _read_vtk(filename)
    raise ValueError(
        f"Unsupported mesh format for '{filename}' "
        "(built-in readers: .msh v2.2/v4.1 ASCII+binary, .vtk legacy "
        "ASCII+binary; install meshio for other formats)")


# -- Gmsh ---------------------------------------------------------------

def _section(buf, name):
    """Byte range of a $name section body, or None."""
    start = buf.find(b"$" + name + b"\n")
    if start < 0:
        start = buf.find(b"$" + name + b"\r\n")
        if start < 0:
            return None
    body_start = buf.index(b"\n", start) + 1
    end = buf.find(b"$End" + name, body_start)
    if end < 0:
        raise ValueError(f"unterminated ${name.decode()} section")
    return body_start, end


def _tokens_f64(text):
    return np.array(text.split(), dtype=np.float64)


def _read_gmsh(filename: str) -> Mesh:
    with open(filename, "rb") as f:
        buf = f.read()
    sec = _section(buf, b"MeshFormat")
    if sec is None:
        raise ValueError(f"No $MeshFormat in {filename}")
    fmt = buf[sec[0]:sec[1]].split()
    version = float(fmt[0])
    binary = int(fmt[1]) == 1
    if binary:
        # endianness probe: the int 1 written right after the format line
        probe_off = buf.index(b"\n", sec[0]) + 1
        one = np.frombuffer(buf[probe_off:probe_off + 4], "<i4")[0]
        endian = "<" if one == 1 else ">"
    else:
        endian = "<"

    nodes_sec = _section(buf, b"Nodes")
    elems_sec = _section(buf, b"Elements")
    if nodes_sec is None or elems_sec is None:
        raise ValueError(f"Missing $Nodes/$Elements in {filename}")

    if version >= 4.0:
        points, remap = (_gmsh4_nodes_bin(buf, nodes_sec, endian) if binary
                         else _gmsh4_nodes(buf, nodes_sec))
        blocks = (_gmsh4_elements_bin(buf, elems_sec, endian, remap)
                  if binary else _gmsh4_elements(buf, elems_sec, remap))
    else:
        points, remap = (_gmsh2_nodes_bin(buf, nodes_sec, endian) if binary
                         else _gmsh2_nodes(buf, nodes_sec))
        blocks = (_gmsh2_elements_bin(buf, elems_sec, endian, remap)
                  if binary else _gmsh2_elements(buf, elems_sec, remap))

    cells = [CellBlock(t, np.asarray(d, dtype=np.int64))
             for t, d in blocks.items()]
    return Mesh(points, cells)


def _tag_remap(tags):
    """tag -> dense 0-based index lookup (gmsh tags may be sparse)."""
    order = np.argsort(tags, kind="stable")
    remap = np.full(int(tags.max()) + 1, -1, dtype=np.int64)
    remap[tags[order]] = np.arange(len(tags))
    return order, remap


def _gmsh2_nodes(buf, sec):
    text = buf[sec[0]:sec[1]].decode()
    nl = text.index("\n")
    n_nodes = int(text[:nl].split()[0])
    vals = _tokens_f64(text[nl:]).reshape(n_nodes, 4)
    tags = vals[:, 0].astype(np.int64)
    order, remap = _tag_remap(tags)
    return vals[order, 1:4], remap


def _gmsh2_nodes_bin(buf, sec, endian):
    nl = buf.index(b"\n", sec[0])
    n_nodes = int(buf[sec[0]:nl].split()[0])
    rec = np.dtype([("tag", endian + "i4"), ("xyz", endian + "f8", (3,))])
    data = np.frombuffer(buf, dtype=rec, count=n_nodes, offset=nl + 1)
    tags = data["tag"].astype(np.int64)
    order, remap = _tag_remap(tags)
    return data["xyz"].astype(np.float64)[order], remap


def _walk_elem_tokens(tok, n_elems, remap, one_based_fallback=True):
    """Vectorized run-detection walk over a v2.2 $Elements token array.

    Each element line is [tag, etype, ntags, tags..., conn...]; runs of
    identical (etype, ntags) are parsed with one reshape.  The run length
    is found by comparing the etype field at the candidate stride — the
    first mismatch bounds the run, values beyond it are never used.
    """
    blocks: dict[str, list] = {}
    cursor = 0
    parsed = 0
    while parsed < n_elems:
        etype = int(tok[cursor + 1])
        ntags = int(tok[cursor + 2])
        npts = _GMSH_TYPES[etype][1] if etype in _GMSH_TYPES else None
        if npts is None:
            raise ValueError(f"unsupported gmsh element type {etype}")
        stride = 3 + ntags + npts
        max_run = min(n_elems - parsed, (len(tok) - cursor) // stride)
        probe = tok[cursor + 1:cursor + 1 + max_run * stride:stride]
        tagprobe = tok[cursor + 2:cursor + 2 + max_run * stride:stride]
        ok = (probe == etype) & (tagprobe == ntags)
        run = int(np.argmin(ok)) if not ok.all() else max_run
        run = max(run, 1)
        chunk = tok[cursor:cursor + run * stride].reshape(run, stride)
        conn = chunk[:, 3 + ntags:].astype(np.int64)
        conn = remap[conn] if remap is not None else conn - 1
        name = _GMSH_TYPES[etype][0]
        blocks.setdefault(name, []).append(conn)
        cursor += run * stride
        parsed += run
    return {t: np.concatenate(parts, axis=0) for t, parts in blocks.items()}


def _gmsh2_elements(buf, sec, remap):
    text = buf[sec[0]:sec[1]].decode()
    nl = text.index("\n")
    n_elems = int(text[:nl].split()[0])
    tok = _tokens_f64(text[nl:]).astype(np.int64)
    return _walk_elem_tokens(tok, n_elems, remap)


def _gmsh2_elements_bin(buf, sec, endian, remap):
    nl = buf.index(b"\n", sec[0])
    n_elems = int(buf[sec[0]:nl].split()[0])
    off = nl + 1
    i4 = np.dtype(endian + "i4")
    blocks: dict[str, list] = {}
    parsed = 0
    while parsed < n_elems:
        etype, count, ntags = np.frombuffer(buf, i4, 3, off)
        off += 12
        if int(etype) not in _GMSH_TYPES:
            raise ValueError(f"unsupported gmsh element type {int(etype)}")
        name, npts = _GMSH_TYPES[int(etype)]
        stride = 1 + int(ntags) + npts
        recs = np.frombuffer(buf, i4, int(count) * stride, off).reshape(
            int(count), stride)
        off += int(count) * stride * 4
        conn = recs[:, 1 + int(ntags):].astype(np.int64)
        conn = remap[conn] if remap is not None else conn - 1
        blocks.setdefault(name, []).append(conn)
        parsed += int(count)
    return {t: np.concatenate(p, axis=0) for t, p in blocks.items()}


def _gmsh4_nodes(buf, sec):
    text = buf[sec[0]:sec[1]].decode()
    tok = _tokens_f64(text)
    num_blocks, n_nodes = int(tok[0]), int(tok[1])
    pts = np.empty((n_nodes, 3), dtype=np.float64)
    tags = np.empty(n_nodes, dtype=np.int64)
    cur = 4
    filled = 0
    for _ in range(num_blocks):
        nb = int(tok[cur + 3])
        cur += 4
        tags[filled:filled + nb] = tok[cur:cur + nb].astype(np.int64)
        cur += nb
        pts[filled:filled + nb] = tok[cur:cur + 3 * nb].reshape(nb, 3)
        cur += 3 * nb
        filled += nb
    order, remap = _tag_remap(tags)
    return pts[order], remap


def _gmsh4_nodes_bin(buf, sec, endian):
    # v4.1 binary: the size_t header starts right at the section body
    # (no ASCII count line, unlike v2.2 binary)
    hdr = np.frombuffer(buf, endian + "u8", 4, sec[0])
    num_blocks, n_nodes = int(hdr[0]), int(hdr[1])
    off = sec[0] + 32
    pts = np.empty((n_nodes, 3), dtype=np.float64)
    tags = np.empty(n_nodes, dtype=np.int64)
    filled = 0
    for _ in range(num_blocks):
        nb = int(np.frombuffer(buf, endian + "u8", 1, off + 12)[0])
        off += 20
        tags[filled:filled + nb] = np.frombuffer(buf, endian + "u8", nb, off)
        off += 8 * nb
        pts[filled:filled + nb] = np.frombuffer(
            buf, endian + "f8", 3 * nb, off).reshape(nb, 3)
        off += 24 * nb
        filled += nb
    order, remap = _tag_remap(tags)
    return pts[order], remap


def _gmsh4_elements(buf, sec, remap):
    text = buf[sec[0]:sec[1]].decode()
    tok = _tokens_f64(text).astype(np.int64)
    num_blocks = int(tok[0])
    blocks: dict[str, list] = {}
    cur = 4
    for _ in range(num_blocks):
        etype, nb = int(tok[cur + 2]), int(tok[cur + 3])
        cur += 4
        if etype not in _GMSH_TYPES:
            raise ValueError(f"unsupported gmsh element type {etype}")
        name, npts = _GMSH_TYPES[etype]
        recs = tok[cur:cur + nb * (1 + npts)].reshape(nb, 1 + npts)
        conn = remap[recs[:, 1:]] if remap is not None else recs[:, 1:] - 1
        blocks.setdefault(name, []).append(conn)
        cur += nb * (1 + npts)
    return {t: np.concatenate(p, axis=0) for t, p in blocks.items()}


def _gmsh4_elements_bin(buf, sec, endian, remap):
    hdr = np.frombuffer(buf, endian + "u8", 4, sec[0])
    num_blocks = int(hdr[0])
    off = sec[0] + 32
    blocks: dict[str, list] = {}
    for _ in range(num_blocks):
        etype = int(np.frombuffer(buf, endian + "i4", 3, off)[2])
        nb = int(np.frombuffer(buf, endian + "u8", 1, off + 12)[0])
        off += 20
        if etype not in _GMSH_TYPES:
            raise ValueError(f"unsupported gmsh element type {etype}")
        name, npts = _GMSH_TYPES[etype]
        recs = np.frombuffer(buf, endian + "u8", nb * (1 + npts),
                             off).reshape(nb, 1 + npts).astype(np.int64)
        off += 8 * nb * (1 + npts)
        conn = remap[recs[:, 1:]] if remap is not None else recs[:, 1:] - 1
        blocks.setdefault(name, []).append(conn)
    return {t: np.concatenate(p, axis=0) for t, p in blocks.items()}


def _read_vtk(filename: str) -> Mesh:
    with open(filename, "rb") as f:
        head = f.read(256)
    mode = head.split(b"\n")[2].strip().upper()
    if mode == b"BINARY":
        return _read_vtk_binary(filename)
    return _read_vtk_ascii(filename)


_VTK_DTYPES = {"float": ">f4", "double": ">f8", "int": ">i4",
               "long": ">i8", "unsigned_int": ">u4", "char": ">i1",
               "unsigned_char": ">u1", "short": ">i2", "vtktypeint64": ">i8"}


def _read_vtk_binary(filename: str) -> Mesh:
    """Legacy VTK unstructured grid, BINARY mode (big-endian blocks
    separated by ASCII header lines)."""
    with open(filename, "rb") as f:
        buf = f.read()

    pos = 0
    n = len(buf)

    def next_line():
        nonlocal pos
        e = buf.index(b"\n", pos)
        line = buf[pos:e].decode("latin1").strip()
        pos = e + 1
        return line

    def read_block(count, dtype):
        nonlocal pos
        dt = np.dtype(dtype)
        arr = np.frombuffer(buf, dt, count, pos)
        pos += count * dt.itemsize
        if buf[pos:pos + 1] == b"\n":
            pos += 1
        return arr

    points = None
    conn_flat = offsets = types = None
    point_data: dict[str, np.ndarray] = {}
    cell_data_flat: dict[str, np.ndarray] = {}
    section = None
    n_points = n_cells = 0
    while pos < n:
        line = next_line()
        if not line:
            continue
        parts = line.split()
        key = parts[0].upper()
        if key == "POINTS":
            n_points = int(parts[1])
            dt = _VTK_DTYPES[parts[2].lower()]
            points = read_block(n_points * 3, dt).astype(
                np.float64).reshape(n_points, 3)
        elif key == "CELLS":
            n_cells = int(parts[1])
            raw = read_block(int(parts[2]), ">i4").astype(np.int64)
            conn_flat, offsets = _unpack_vtk_cells(raw)
        elif key == "CELL_TYPES":
            types = read_block(int(parts[1]), ">i4").astype(np.int64)
        elif key == "POINT_DATA":
            section = "point"
        elif key == "CELL_DATA":
            section = "cell"
        elif key == "FIELD":
            for _ in range(int(parts[2])):
                fparts = next_line().split()
                while not fparts:
                    fparts = next_line().split()
                name, ncomp, ntup = fparts[0], int(fparts[1]), int(fparts[2])
                dt = _VTK_DTYPES[fparts[3].lower()]
                vals = read_block(ncomp * ntup, dt).astype(np.float64)
                arr = vals.reshape(ntup, ncomp) if ncomp > 1 else vals
                (point_data if section == "point"
                 else cell_data_flat)[name] = arr
        elif key in ("SCALARS", "VECTORS", "TENSORS"):
            name = parts[1]
            ncomp = {"SCALARS": 1, "VECTORS": 3, "TENSORS": 9}[key]
            if key == "SCALARS" and len(parts) >= 4:
                ncomp = int(parts[3])
            dt = _VTK_DTYPES[parts[2].lower()]
            if key == "SCALARS":
                next_line()  # LOOKUP_TABLE
            count = (n_points if section == "point" else n_cells) * ncomp
            vals = read_block(count, dt).astype(np.float64)
            arr = vals.reshape(-1, ncomp) if ncomp > 1 else vals
            (point_data if section == "point"
             else cell_data_flat)[name] = arr
    if points is None or types is None:
        raise ValueError(f"Malformed VTK file {filename}")
    return _vtk_assemble(filename, points, conn_flat, offsets, types,
                         point_data, cell_data_flat)


def _unpack_vtk_cells(raw):
    """[npts, p0..pk, npts, ...] -> (flat connectivity, offsets)."""
    conn_flat, offsets = [], [0]
    j = 0
    while j < len(raw):
        cnt = int(raw[j])
        conn_flat.extend(raw[j + 1:j + 1 + cnt].tolist())
        offsets.append(offsets[-1] + cnt)
        j += 1 + cnt
    return np.asarray(conn_flat, dtype=np.int64), offsets


def _vtk_assemble(filename, points, conn_flat, offsets, types,
                  point_data, cell_data_flat):
    # group cells by type, preserving original order within each type
    blocks = []
    order_per_type: dict[str, np.ndarray] = {}
    for tid, (name, npts) in _VTK_TYPES.items():
        sel = np.nonzero(types == tid)[0]
        if len(sel) == 0:
            continue
        conn = np.stack([
            conn_flat[offsets[s]:offsets[s + 1]] for s in sel
        ])
        blocks.append(CellBlock(name, conn))
        order_per_type[name] = sel
    cell_data = {}
    for var, arr in cell_data_flat.items():
        cell_data[var] = [np.asarray(arr)[order_per_type[b.type]]
                          for b in blocks]
    return Mesh(points, blocks, point_data, cell_data)


def _read_vtk_ascii(filename: str) -> Mesh:
    with open(filename) as f:
        tokens_lines = f.read().split("\n")
    # tokenize lazily section by section
    i = 0
    n = len(tokens_lines)
    points = None
    conn_flat = None
    offsets = None
    types = None
    point_data: dict[str, np.ndarray] = {}
    cell_data_flat: dict[str, np.ndarray] = {}
    section = None
    n_points = n_cells = 0
    while i < n:
        parts = tokens_lines[i].split()
        if not parts:
            i += 1
            continue
        key = parts[0].upper()
        if key == "POINTS":
            n_points = int(parts[1])
            vals, i = _vtk_read_floats(tokens_lines, i + 1, n_points * 3)
            points = vals.reshape(n_points, 3)
            continue
        if key == "CELLS":
            n_cells = int(parts[1])
            total = int(parts[2])
            vals, i = _vtk_read_floats(tokens_lines, i + 1, total)
            conn_flat, offsets = _unpack_vtk_cells(vals.astype(np.int64))
            continue
        if key == "CELL_TYPES":
            cnt = int(parts[1])
            vals, i = _vtk_read_floats(tokens_lines, i + 1, cnt)
            types = vals.astype(np.int64)
            continue
        if key == "POINT_DATA":
            section = "point"
            i += 1
            continue
        if key == "CELL_DATA":
            section = "cell"
            i += 1
            continue
        if key in ("SCALARS", "VECTORS", "TENSORS", "FIELD"):
            if key == "FIELD":
                n_arrays = int(parts[2])
                i += 1
                for _ in range(n_arrays):
                    fparts = tokens_lines[i].split()
                    name, ncomp, ntup = fparts[0], int(fparts[1]), int(fparts[2])
                    vals, i = _vtk_read_floats(tokens_lines, i + 1, ncomp * ntup)
                    arr = vals.reshape(ntup, ncomp) if ncomp > 1 else vals
                    (point_data if section == "point" else
                     cell_data_flat)[name] = arr
                continue
            name = parts[1]
            ncomp = {"SCALARS": 1, "VECTORS": 3, "TENSORS": 9}[key]
            if key == "SCALARS" and len(parts) >= 4:
                ncomp = int(parts[3])
            count = (n_points if section == "point" else n_cells) * ncomp
            j = i + 1
            if key == "SCALARS" and tokens_lines[j].split()[:1] == ["LOOKUP_TABLE"]:
                j += 1
            vals, i = _vtk_read_floats(tokens_lines, j, count)
            arr = vals.reshape(-1, ncomp) if ncomp > 1 else vals
            (point_data if section == "point" else cell_data_flat)[name] = arr
            continue
        i += 1

    if points is None or types is None:
        raise ValueError(f"Malformed VTK file {filename}")
    return _vtk_assemble(filename, points, conn_flat, offsets, types,
                         point_data, cell_data_flat)


def _vtk_read_floats(lines, i, count):
    vals = []
    while len(vals) < count:
        vals.extend(float(t) for t in lines[i].split())
        i += 1
    return np.asarray(vals[:count], dtype=np.float64), i


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------

def write(filename: str, mesh: Mesh, binary: bool = False,
          msh_version: str = "2.2") -> None:
    name = str(filename).lower()
    if name.endswith(".msh"):
        if msh_version.startswith("4"):
            _write_gmsh4(filename, mesh, binary)
        else:
            (_write_gmsh2_binary if binary else _write_gmsh2)(filename, mesh)
    elif name.endswith(".vtk"):
        (_write_vtk_binary if binary else _write_vtk)(filename, mesh)
    else:
        raise ValueError(f"Unsupported output format for '{filename}'")


def _write_gmsh4(filename: str, mesh: Mesh, binary: bool) -> None:
    """Gmsh .msh v4.1 (one entity block for nodes, one per cell block)."""
    n_pts = len(mesh.points)
    pts = np.asarray(mesh.points, dtype=np.float64)
    n_elems = sum(len(b) for b in mesh.cells)
    with open(filename, "wb") as f:
        if binary:
            f.write(b"$MeshFormat\n4.1 1 8\n")
            f.write(np.int32(1).tobytes())
            f.write(b"\n$EndMeshFormat\n$Nodes\n")
            f.write(np.asarray([1, n_pts, 1, n_pts], "<u8").tobytes())
            f.write(np.asarray([3, 1, 0], "<i4").tobytes())
            f.write(np.asarray([n_pts], "<u8").tobytes())
            f.write(np.arange(1, n_pts + 1, dtype="<u8").tobytes())
            f.write(pts.astype("<f8").tobytes())
            f.write(b"\n$EndNodes\n$Elements\n")
            f.write(np.asarray([len(mesh.cells), n_elems, 1, n_elems],
                               "<u8").tobytes())
            eid = 1
            for bi, block in enumerate(mesh.cells):
                nb, npts = block.data.shape
                f.write(np.asarray([3, bi + 1,
                                    _GMSH_TYPE_IDS[block.type]],
                                   "<i4").tobytes())
                f.write(np.asarray([nb], "<u8").tobytes())
                recs = np.empty((nb, 1 + npts), dtype="<u8")
                recs[:, 0] = np.arange(eid, eid + nb)
                recs[:, 1:] = block.data + 1
                f.write(recs.tobytes())
                eid += nb
            f.write(b"\n$EndElements\n")
            return
        out = ["$MeshFormat\n4.1 0 8\n$EndMeshFormat\n$Nodes\n",
               f"1 {n_pts} 1 {n_pts}\n", f"3 1 0 {n_pts}\n"]
        out.extend(f"{i + 1}\n" for i in range(n_pts))
        out.extend(f"{p[0]:.17g} {p[1]:.17g} {p[2]:.17g}\n" for p in pts)
        out.append("$EndNodes\n$Elements\n")
        out.append(f"{len(mesh.cells)} {n_elems} 1 {n_elems}\n")
        eid = 1
        for bi, block in enumerate(mesh.cells):
            nb = len(block)
            out.append(f"3 {bi + 1} {_GMSH_TYPE_IDS[block.type]} {nb}\n")
            for cell in block.data:
                out.append(f"{eid} " + " ".join(str(c + 1) for c in cell)
                           + "\n")
                eid += 1
        out.append("$EndElements\n")
        f.write("".join(out).encode())


def _write_gmsh2_binary(filename: str, mesh: Mesh) -> None:
    """Gmsh .msh v2.2, binary file-type (little-endian + probe int)."""
    with open(filename, "wb") as f:
        f.write(b"$MeshFormat\n2.2 1 8\n")
        f.write(np.int32(1).tobytes())
        f.write(b"\n$EndMeshFormat\n$Nodes\n")
        n_pts = len(mesh.points)
        f.write(f"{n_pts}\n".encode())
        rec = np.empty(n_pts, dtype=[("tag", "<i4"), ("xyz", "<f8", (3,))])
        rec["tag"] = np.arange(1, n_pts + 1)
        rec["xyz"] = np.asarray(mesh.points, dtype=np.float64)
        f.write(rec.tobytes())
        f.write(b"\n$EndNodes\n$Elements\n")
        n_elems = sum(len(b) for b in mesh.cells)
        f.write(f"{n_elems}\n".encode())
        eid = 1
        for block in mesh.cells:
            tid = _GMSH_TYPE_IDS[block.type]
            nb, npts = block.data.shape
            f.write(np.asarray([tid, nb, 2], "<i4").tobytes())
            recs = np.empty((nb, 3 + npts), dtype="<i4")
            recs[:, 0] = np.arange(eid, eid + nb)
            recs[:, 1:3] = 0
            recs[:, 3:] = block.data + 1
            f.write(recs.tobytes())
            eid += nb
        f.write(b"\n$EndElements\n")


def _write_vtk_binary(filename: str, mesh: Mesh) -> None:
    """Legacy VTK unstructured grid, BINARY mode (big-endian)."""
    with open(filename, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0\nninpol_tpu mesh\nBINARY\n")
        f.write(b"DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {len(mesh.points)} double\n".encode())
        f.write(np.asarray(mesh.points, ">f8").tobytes())
        f.write(b"\n")
        n_cells = sum(len(b) for b in mesh.cells)
        total = sum(len(b) * (b.data.shape[1] + 1) for b in mesh.cells)
        f.write(f"CELLS {n_cells} {total}\n".encode())
        for block in mesh.cells:
            nb, npts = block.data.shape
            recs = np.empty((nb, 1 + npts), dtype=">i4")
            recs[:, 0] = npts
            recs[:, 1:] = block.data
            f.write(recs.tobytes())
        f.write(b"\n")
        f.write(f"CELL_TYPES {n_cells}\n".encode())
        for block in mesh.cells:
            tid = _VTK_TYPE_IDS[block.type]
            f.write(np.full(len(block), tid, ">i4").tobytes())
        f.write(b"\n")

        def _write_field(name, arr):
            arr = np.asarray(arr, dtype=np.float64)
            ncomp = arr.shape[1] if arr.ndim > 1 else 1
            ntup = len(arr)
            f.write(f"{name} {ncomp} {ntup} double\n".encode())
            f.write(arr.astype(">f8").tobytes())
            f.write(b"\n")

        if mesh.cell_data:
            f.write(f"CELL_DATA {n_cells}\n".encode())
            f.write(f"FIELD FieldData {len(mesh.cell_data)}\n".encode())
            for var, blocks in mesh.cell_data.items():
                parts = [np.atleast_2d(np.asarray(b, dtype=np.float64).T).T
                         for b in blocks]
                merged = np.concatenate(parts, axis=0)
                _write_field(var, merged[:, 0] if merged.shape[1] == 1
                             else merged)
        if mesh.point_data:
            f.write(f"POINT_DATA {len(mesh.points)}\n".encode())
            f.write(f"FIELD FieldData {len(mesh.point_data)}\n".encode())
            for var, arr in mesh.point_data.items():
                _write_field(var, arr)


def _write_gmsh2(filename: str, mesh: Mesh) -> None:
    with open(filename, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n")
        f.write(f"{len(mesh.points)}\n")
        for i, p in enumerate(mesh.points):
            f.write(f"{i + 1} {p[0]:.17g} {p[1]:.17g} {p[2]:.17g}\n")
        f.write("$EndNodes\n$Elements\n")
        n_elems = sum(len(b) for b in mesh.cells)
        f.write(f"{n_elems}\n")
        eid = 1
        for block in mesh.cells:
            tid = _GMSH_TYPE_IDS[block.type]
            for cell in block.data:
                conn = " ".join(str(c + 1) for c in cell)
                f.write(f"{eid} {tid} 2 0 0 {conn}\n")
                eid += 1
        f.write("$EndElements\n")


def _write_vtk(filename: str, mesh: Mesh) -> None:
    with open(filename, "w") as f:
        f.write("# vtk DataFile Version 3.0\nninpol_tpu mesh\nASCII\n")
        f.write("DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {len(mesh.points)} double\n")
        for p in mesh.points:
            f.write(f"{p[0]:.17g} {p[1]:.17g} {p[2]:.17g}\n")
        n_cells = sum(len(b) for b in mesh.cells)
        total = sum(len(b) * (b.data.shape[1] + 1) for b in mesh.cells)
        f.write(f"CELLS {n_cells} {total}\n")
        for block in mesh.cells:
            for cell in block.data:
                f.write(f"{len(cell)} " + " ".join(map(str, cell)) + "\n")
        f.write(f"CELL_TYPES {n_cells}\n")
        for block in mesh.cells:
            tid = _VTK_TYPE_IDS[block.type]
            f.write((f"{tid}\n") * len(block))

        def _write_field(name, arr):
            arr = np.asarray(arr, dtype=np.float64)
            ncomp = arr.shape[1] if arr.ndim > 1 else 1
            flat = arr.reshape(-1)
            f.write(f"{name} {ncomp} {len(flat) // ncomp} double\n")
            for i in range(0, len(flat), 9):
                f.write(" ".join(f"{v:.17g}" for v in flat[i:i + 9]) + "\n")

        if mesh.cell_data:
            f.write(f"CELL_DATA {n_cells}\n")
            f.write(f"FIELD FieldData {len(mesh.cell_data)}\n")
            for var, blocks in mesh.cell_data.items():
                parts = [np.atleast_2d(np.asarray(b, dtype=np.float64).T).T
                         for b in blocks]
                merged = np.concatenate(parts, axis=0)
                _write_field(var,
                             merged[:, 0] if merged.shape[1] == 1 else merged)
        if mesh.point_data:
            f.write(f"POINT_DATA {len(mesh.points)}\n")
            f.write(f"FIELD FieldData {len(mesh.point_data)}\n")
            for var, arr in mesh.point_data.items():
                _write_field(var, arr)
