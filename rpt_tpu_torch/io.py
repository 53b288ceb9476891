"""Asset I/O: Wavefront OBJ (+MTL), STL and Radiance HDR loading — the
port's own copy of `rpt_tpu/io.py` (`rpt/src/io.rs`), on the port's
`Mesh`, `Material` and `Object`.

Reference behaviour kept: negative indices (io.rs:11-19), fan
triangulation with flat normals where a corner lacks a ``vn``
(io.rs:164-201), the warn-and-skip handling of ``vt``/``mtllib``/
``usemtl`` (io.rs:47-67), per-``usemtl`` object splitting (io.rs:84-150),
binary STL detection by size = 84 + 50n (io.rs:264-291), and the refusal
to parse MTL properties (io.rs:225).

OBJ text is tokenized line by line in Python; floats are parsed with
``float`` as the JAX package does, and triangles and normals are then
gathered with one numpy index per array, so the arrays are identical to
`rpt_tpu.io`'s. `load_hdr` decodes Radiance RGBE itself (flat and
adaptive-RLE rows); it needs neither imageio nor Pillow.
"""

from __future__ import annotations

import sys

import numpy as np

from .materials import Material
from .scene import Object
from .shapes import Mesh, flat_normals


def _parse_index(value: str, length: int) -> int | None:
    """1-based or negative OBJ index -> 0-based (io.rs:11-19), ``length``
    being the entries read so far; None where the field is empty or not an
    integer."""
    if not value:
        return None
    try:
        idx = int(value)
    except ValueError:
        return None
    return idx - 1 if idx > 0 else length + idx


def _resolve(idx: int, length: int) -> int:
    """The entry that the JAX package's list lookup ``entries[idx]`` reads
    among the ``length`` read so far (a negative index wraps once more);
    IndexError outside them, as the list raises."""
    if idx < 0:
        idx += length
    if not 0 <= idx < length:
        raise IndexError("list index out of range")
    return idx


def _point(tokens) -> list:
    return [float(tokens[1]), float(tokens[2]), float(tokens[3])]


def _warn(kind: str):
    print(f"Warning: Found '{kind}' in .OBJ file, unimplemented, skipping...", file=sys.stderr)


class _ObjReader:
    """Vertices, normals and fan-triangulated corner indices of an OBJ, in
    file order; ``take()`` turns the triangles read since the last call
    into a `Mesh`."""

    def __init__(self):
        self.vertices, self.normals = [], []
        self.tri_v, self.tri_n = [], []  # 3 indices a triangle; -1: no vn

    def line(self, tokens) -> bool:
        """Consume a ``v``, ``vn`` or ``f`` line; False for any other."""
        kind = tokens[0]
        if kind == "v":
            self.vertices.append(_point(tokens))
        elif kind == "vn":
            self.normals.append(_point(tokens))
        elif kind == "f":
            self._face(tokens)
        else:
            return False
        return True

    def _face(self, tokens):
        """Fan triangulation of an ``f`` line (io.rs:164-201)."""
        nv, nn = len(self.vertices), len(self.normals)
        vi, vni = [], []
        for vertex in tokens[1:]:
            args = (vertex.split("/") + ["", ""])[:3]
            idx = _parse_index(args[0], nv)
            if idx is None:
                raise ValueError("Invalid vertex index")
            vi.append(idx)
            vni.append(_parse_index(args[2], nn))
        for i in range(1, len(vi) - 1):
            self.tri_v.append(tuple(_resolve(vi[c], nv) for c in (0, i, i + 1)))
            corners = (vni[0], vni[i], vni[i + 1])
            self.tri_n.append((-1, -1, -1) if None in corners
                              else tuple(_resolve(c, nn) for c in corners))

    def take(self) -> Mesh:
        tri_v, tri_n = self.tri_v, self.tri_n
        self.tri_v, self.tri_n = [], []
        if not tri_v:
            return Mesh(np.zeros((0, 3, 3)))
        v = np.asarray(self.vertices, np.float64)[np.asarray(tri_v)]
        n = flat_normals(v)
        tri_n = np.asarray(tri_n)
        smooth = tri_n[:, 0] >= 0
        if smooth.any():
            n[smooth] = np.asarray(self.normals, np.float64)[tri_n[smooth]]
        return Mesh(v, n)


def load_obj(path_or_file) -> Mesh:
    """Load mesh geometry from a Wavefront .OBJ file (io.rs:28-74)."""
    reader = _ObjReader()
    for line in _read_lines(path_or_file):
        tokens = line.split()
        if not tokens or tokens[0].startswith("#") or reader.line(tokens):
            continue
        if tokens[0] in ("vt", "mtllib", "usemtl"):
            _warn(tokens[0])
    return reader.take()


def load_obj_with_mtl(obj_path, mtl_path) -> list:
    """Load objects with materials, splitting on ``usemtl`` changes
    (io.rs:84-150). Returns a list of `Object`."""
    materials = load_mtl(mtl_path)
    reader = _ObjReader()
    objects = []
    material, last_usemtl = Material(), None

    def flush():
        if reader.tri_v:
            objects.append(Object(reader.take(), material))

    for line in _read_lines(obj_path):
        tokens = line.split()
        if not tokens or tokens[0].startswith("#") or reader.line(tokens):
            continue
        if tokens[0] == "vt":
            _warn("vt")
        elif tokens[0] == "usemtl" and last_usemtl != tokens[1]:
            flush()
            if tokens[1] not in materials:
                raise ValueError(f"Could not found `usemtl {tokens[1]}` in library")
            material, last_usemtl = materials[tokens[1]], tokens[1]
    flush()
    return objects


def load_mtl(path_or_file) -> dict:
    """Parse a .MTL library (io.rs:203-258). As in the reference, only
    ``newmtl`` declarations are supported; any material property raises
    (io.rs:225: ``panic!("MTL loading not implemented")``)."""
    materials: dict[str, Material] = {}
    current = None
    for line in _read_lines(path_or_file):
        tokens = line.split()
        if not tokens or tokens[0].startswith("#"):
            continue
        if tokens[0] == "newmtl":
            current = tokens[1]
            materials.setdefault(current, Material())
        elif current is None:
            raise ValueError(
                "Material was not specified with `newmtl` before properties were added")
        else:
            raise NotImplementedError("MTL loading not implemented")
    return materials


def load_stl(path_or_file) -> Mesh:
    """Load a mesh from .STL, binary where the size is 84 + 50n for the
    header's n, else ASCII (io.rs:264-291)."""
    data = _read_bytes(path_or_file)
    if len(data) < 15:
        raise ValueError("Loaded .STL file is too short")
    if len(data) >= 84:
        num_triangles = int(np.frombuffer(data[80:84], "<u4")[0])
        if len(data) == 84 + num_triangles * 50:
            return _load_stl_binary(data, num_triangles)
    if data[:6] == b"solid ":
        return _load_stl_ascii(data)
    raise ValueError("Loaded .STL file, but could not determine format")


def _load_stl_binary(data: bytes, num_triangles: int) -> Mesh:
    """50-byte records: normal + 3 verts (f32) + u16 attr (io.rs:335-364)."""
    rec = np.frombuffer(data[84:], np.uint8).reshape(num_triangles, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(num_triangles, 4, 3).astype(np.float64)
    return Mesh(floats[:, 1:4], np.repeat(floats[:, :1], 3, axis=1))


def _load_stl_ascii(data: bytes) -> Mesh:
    lines = data.decode("utf-8", errors="replace").splitlines()[1:]
    tris, norms = [], []
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if not line.startswith("facet normal "):
            if line.startswith("endsolid") or not line:
                break
            raise ValueError("Malformed STL file: expected `facet normal`")
        vn = [float(t) for t in line[len("facet normal "):].split()]
        vs = []
        for j in range(2, 5):
            vline = lines[i + j].strip()
            if not vline.startswith("vertex "):
                raise ValueError("Malformed STL file: expected `vertex`")
            vs.append([float(t) for t in vline[len("vertex "):].split()])
        tris.append(vs)
        norms.append([vn, vn, vn])
        i += 7  # facet normal / outer loop / 3 vertices / endloop / endfacet
    return Mesh(np.asarray(tris, np.float64), np.asarray(norms, np.float64))


def load_hdr(path_or_file) -> np.ndarray:
    """Decode a Radiance .hdr image to linear (H, W, 3) float64, as
    `rpt_tpu.io._decode_rgbe`: flat or adaptive-RLE rows, each pixel
    mantissa * 2^(e - 136), and black where e = 0."""
    data = _read_bytes(path_or_file)
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("Not a Radiance HDR file")
    rest = data[data.index(b"\n\n") + 2:] if b"\n\n" in data else data
    dims_end = rest.index(b"\n")
    dims = rest[:dims_end].split()
    height, width = int(dims[1]), int(dims[3])
    buf = rest[dims_end + 1:]
    out = np.zeros((height, width, 4), np.uint8)
    off = 0
    for y in range(height):
        if buf[off] == 2 and buf[off + 1] == 2:  # adaptive RLE, one channel at a time
            off += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = buf[off]
                    off += 1
                    if count > 128:  # a run of one byte
                        out[y, x:x + count - 128, c] = buf[off]
                        off += 1
                        x += count - 128
                    else:  # count literal bytes
                        out[y, x:x + count, c] = np.frombuffer(buf[off:off + count], np.uint8)
                        off += count
                        x += count
        else:  # flat RGBE
            out[y] = np.frombuffer(buf[off:off + width * 4], np.uint8).reshape(width, 4)
            off += width * 4
    rgb = out[..., :3].astype(np.float64) * np.ldexp(1.0, out[..., 3:].astype(np.int32) - 136)
    rgb[out[..., 3] == 0] = 0.0
    return rgb


def _read_bytes(path_or_file) -> bytes:
    if hasattr(path_or_file, "read"):
        return path_or_file.read()
    with open(path_or_file, "rb") as f:
        return f.read()


def _read_lines(path_or_file) -> list[str]:
    if hasattr(path_or_file, "read"):
        content = path_or_file.read()
        if isinstance(content, bytes):
            content = content.decode("utf-8", errors="replace")
        return content.splitlines()
    with open(path_or_file, "r", errors="replace") as f:
        return f.read().splitlines()
