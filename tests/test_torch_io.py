"""Asset I/O of the port against `rpt_tpu.io` on the CPU: every mesh under
`data/` loads to identical vertex and normal arrays, `tests/test_io.py`'s
cases hold for both packages, and `load_hdr` decodes flat and RLE
Radiance files bit for bit as `rpt_tpu.io._decode_rgbe` does.

Tolerance: none. Both packages parse the same text with Python's
``float`` and gather the same float64 rows, so arrays are compared with
`np.array_equal`.
"""

import io as _io
import os
import struct

import numpy as np
import pytest

from rpt_tpu import io as jio
import rpt_tpu_torch as tr
from rpt_tpu_torch import io as tio

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
FILES = sorted(os.listdir(DATA))

OBJ_SIMPLE = "# comment\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n"
OBJ_NORMALS = "v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//1\n"
OBJ_NEGATIVE = "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n"
# a pentagon fan with normals on some corners only, negative indices
# counted from the vertices read so far, a 'vt' line and a 'v/vt/vn' face
OBJ_MIXED = ("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0.5 1.5 0\nv 0 1 0\nvn 0 0 1\nvn 0 1 0\n"
             "vt 0 0\nf 1//1 2//1 3//2 4 5//2\nv 2 2 2\nf -1/1/2 -2/1/1 -3/1/1\n")
STL_ASCII = ("solid cube\nfacet normal 0 0 1\n outer loop\n  vertex 0 0 0\n  vertex 1 0 0\n"
             "  vertex 0 1 0\n endloop\nendfacet\nendsolid cube\n")


def _same(a, b):
    assert type(b).__module__.startswith("rpt_tpu_torch")
    assert len(a) == len(b)
    assert a.vertices.dtype == b.vertices.dtype == np.float64
    assert np.array_equal(a.vertices, b.vertices)
    assert np.array_equal(a.normals, b.normals)


@pytest.mark.parametrize("name", FILES)
def test_data_files_load_identically(name):
    """`data/*.obj|stl` (cylinder.stl is binary despite its `solid `
    header: detected by size)."""
    loader = "load_stl" if name.endswith(".stl") else "load_obj"
    path = os.path.join(DATA, name)
    _same(getattr(jio, loader)(path), getattr(tio, loader)(path))


@pytest.mark.parametrize("text", [OBJ_SIMPLE, OBJ_NORMALS, OBJ_NEGATIVE, OBJ_MIXED],
                         ids=["fan", "normals", "negative", "mixed"])
def test_obj_cases_match(text):
    """`tests/test_io.py`'s OBJ cases, on both packages, plus a mixed one."""
    j, t = jio.load_obj(_io.StringIO(text)), tr.load_obj(_io.StringIO(text))
    _same(j, t)
    if text is OBJ_SIMPLE:
        assert len(t) == 2 and np.allclose(t.vertices[0][0], [0, 0, 0])
    elif text is OBJ_NORMALS:
        assert np.allclose(t.normals[0], [[0, 0, 1]] * 3)
    elif text is OBJ_NEGATIVE:
        assert len(t) == 1 and np.allclose(t.vertices[0][1], [1, 0, 0])
    else:
        # triangles 0-1 have every vn, triangle 2 lacks one: flat normal
        assert len(t) == 4 and np.allclose(t.normals[2], [[0, 0, 1]] * 3)


def test_obj_errors_match():
    for text in ("v 0 0 0\nf x 1 1\n", "v 0 0 0\nf 1 2 3\n", "v 0 0 0\nf 0 1 1\n"):
        with pytest.raises((ValueError, IndexError)) as jerr:
            jio.load_obj(_io.StringIO(text))
        with pytest.raises(jerr.type):
            tr.load_obj(_io.StringIO(text))


def test_load_mtl_and_split_objects():
    mats = tr.load_mtl(_io.StringIO("newmtl a\nnewmtl b\n"))
    assert set(mats) == {"a", "b"} and all(isinstance(m, tr.Material) for m in mats.values())
    # properties raise, as the reference panics (io.rs:225)
    with pytest.raises(NotImplementedError):
        tr.load_mtl(_io.StringIO("newmtl a\nKd 1 0 0\n"))
    with pytest.raises(ValueError):
        tr.load_mtl(_io.StringIO("Kd 1 0 0\n"))
    obj = ("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 3\nusemtl a\nf 1 2 3\nusemtl a\n"
           "f 2 4 3\nusemtl b\nf 2 4 3\n")
    mtl = "newmtl a\nnewmtl b\n"
    j = jio.load_obj_with_mtl(_io.StringIO(obj), _io.StringIO(mtl))
    t = tr.load_obj_with_mtl(_io.StringIO(obj), _io.StringIO(mtl))
    assert len(j) == len(t) == 3 and all(isinstance(o, tr.Object) for o in t)
    for a, b in zip(j, t):
        _same(a.shape, b.shape)
        assert b._material == tr.Material()
    assert [len(o.shape) for o in t] == [1, 2, 1]
    with pytest.raises(ValueError, match="usemtl c"):
        tr.load_obj_with_mtl(_io.StringIO("usemtl c\n"), _io.StringIO(mtl))


def _stl_binary_bytes():
    tri = struct.pack("<12fH", 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0)
    return b"\0" * 80 + struct.pack("<I", 1) + tri


@pytest.mark.parametrize("data", [_stl_binary_bytes(), STL_ASCII.encode()],
                         ids=["binary", "ascii"])
def test_stl_cases_match(data):
    _same(jio.load_stl(_io.BytesIO(data)), tr.load_stl(_io.BytesIO(data)))
    with pytest.raises(ValueError, match="too short"):
        tr.load_stl(_io.BytesIO(b"solid x"))
    with pytest.raises(ValueError, match="determine format"):
        tr.load_stl(_io.BytesIO(b"\1" * 100))


def _rgbe_file(rgbe: np.ndarray, rle_rows=()) -> bytes:
    """A Radiance file of the (H, W, 4) uint8 ``rgbe``: flat rows, except
    the rows in ``rle_rows``, written with adaptive RLE (runs of equal
    bytes and literal stretches, each channel in turn)."""
    h, w, _ = rgbe.shape
    out = [b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n", f"-Y {h} +X {w}\n".encode()]
    for y in range(h):
        if y not in rle_rows:
            out.append(rgbe[y].tobytes())
            continue
        out.append(bytes([2, 2, w >> 8, w & 255]))
        for c in range(4):
            row, x = rgbe[y, :, c], 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and row[x + run] == row[x]:
                    run += 1
                if run >= 3:
                    out.append(bytes([128 + run, row[x]]))
                    x += run
                else:
                    n = min(128, w - x)
                    out.append(bytes([n]) + row[x:x + n].tobytes())
                    x += n
    return b"".join(out)


@pytest.mark.parametrize("rle", [False, True], ids=["flat", "rle"])
def test_load_hdr_matches_reference_decoder(rle):
    """A 7 x 40 image with random mantissas and exponents (seed 0), runs
    of one colour and pixels with e = 0 (black), decoded bit for bit as
    `rpt_tpu.io._decode_rgbe` decodes it, from a path and from a file."""
    rng = np.random.default_rng(0)
    rgbe = rng.integers(0, 256, (7, 40, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.integers(120, 140, (7, 40))
    rgbe[2, 5:30] = (200, 100, 50, 130)  # long runs in every channel
    rgbe[4, ::3, 3] = 0
    data = _rgbe_file(rgbe, rle_rows=range(1, 7, 2) if rle else ())
    ref = jio._decode_rgbe(_io.BytesIO(data))
    got = tr.load_hdr(_io.BytesIO(data))
    assert got.shape == (7, 40, 3) and got.dtype == np.float64
    assert np.array_equal(got, ref)
    assert (got[4, ::3] == 0).all() and got.max() > 0
    mant = rgbe[..., :3].astype(np.float64)
    assert np.array_equal(got[0], mant[0] * np.ldexp(1.0, rgbe[0, :, 3:].astype(int) - 136))
    with pytest.raises(ValueError, match="Radiance"):
        tr.load_hdr(_io.BytesIO(b"P6\n1 1\n255\n\0\0\0"))
