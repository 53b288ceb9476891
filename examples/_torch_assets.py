"""Shared helpers of the PyTorch port's example drivers (the port's side of
`examples/_assets.py`, which imports `rpt_tpu` and jax).

``get_mesh`` and ``get_hdri`` look for an asset under ``data/`` and fall
back to a deterministic procedural stand-in where it is absent, as
`_assets.py` does; ``save`` writes a PNG with the standard library alone
(the GPU machine has no Pillow); ``preview_cut`` says on which device an
example's ``main()`` runs and how much of the work outside its
`Renderer` it does.
"""

import os
import struct
import sys
import zlib

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import rpt_tpu_torch as rpt  # noqa: E402
from rpt_tpu_torch.meshes import displaced_blob  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def get_mesh(name: str, fallback_tris: int = 20000) -> rpt.Mesh:
    """Load ``data/<name>`` (.obj, else .stl) with the port's loaders, or
    synthesize a stand-in blob scaled as `_assets.get_mesh` scales it
    (max half-extent 0.35, base at y = -0.294). The blob's seed is the
    name's CRC-32, so a stand-in is the same in every process."""
    for ext, loader in ((".obj", rpt.load_obj), (".stl", rpt.load_stl)):
        path = os.path.join(DATA, name + ext)
        if os.path.exists(path):
            return loader(path)
    print(f"note: data/{name}.obj not found; using procedural stand-in", file=sys.stderr)
    n = max(8, int((fallback_tris / 2) ** 0.5))
    blob = displaced_blob(n, n + 1, amplitude=0.3, seed=zlib.crc32(name.encode()))
    v = blob.vertices.reshape(-1, 3)
    s = 0.35 / max(float(np.abs(v).max()), 1e-9)
    ty = -0.294 - float(v[:, 1].min()) * s
    return blob.scale((s, s, s)).translate((0.0, ty, 0.0))


def get_hdri(name: str = "ballroom_2k") -> rpt.Hdri:
    """Load ``data/<name>.hdr`` with `rpt_tpu_torch.load_hdr`, or the
    (256, 512) sky-gradient map of `_assets.get_hdri`: a bright horizon
    band, a blue zenith and a small sun."""
    path = os.path.join(DATA, name + ".hdr")
    if os.path.exists(path):
        return rpt.Hdri(rpt.load_hdr(path))
    print(f"note: data/{name}.hdr not found; using procedural sky", file=sys.stderr)
    h, w = 256, 512
    y = np.linspace(0, np.pi, h)[:, None]
    x = np.linspace(0, 2 * np.pi, w)[None, :]
    sky = np.zeros((h, w, 3))
    horizon = np.exp(-(((y - np.pi / 2) / 0.3) ** 2))
    sky[..., 0] = 0.35 + 0.6 * horizon + 0.05 * np.cos(x)
    sky[..., 1] = 0.45 + 0.5 * horizon
    sky[..., 2] = 0.8 - 0.25 * np.cos(y)
    sun = 60.0 * np.exp(-(((y - 0.9) / 0.05) ** 2) - (((x - 2.0) / 0.05) ** 2))
    return rpt.Hdri(sky + sun[..., None] * np.array([1.0, 0.95, 0.9]))


def preview_cut(full=None, preview=None):
    """``(work, device)`` of an example's ``main()``: ``full`` on the card
    (raising where there is none). Under RPT_TPU_PREVIEW, the tiny run
    `tests/test_examples.py` makes of every example, ``preview`` on the
    CPU. The `Renderer` cuts its own resolution, samples and photons
    (`Renderer._apply_preview`); ``full``/``preview`` is the work outside
    it that a driver cuts (the dragon's mesh)."""
    if os.environ.get("RPT_TPU_PREVIEW"):
        return preview, "cpu"
    return full, "cuda"


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save(img, path: str):
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + _png_chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)
    print(f"saved {path}")
