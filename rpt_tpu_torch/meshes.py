"""Procedural meshes (numpy) — port of `rpt_tpu/meshes.py`.

The reference's dragon benchmark downloads the 871k-triangle Stanford
dragon OBJ at run time (`examples/dragon.rs:10-23`); without a network,
``displaced_blob`` makes a deterministic mesh of the same scale and
irregularity (smooth normals, non-uniform triangle density), the same
stand-in the JAX package's `bench.py` uses.
"""

from __future__ import annotations

import numpy as np

from .shapes import Mesh


def uv_sphere(n_u: int, n_v: int, radius: float = 1.0) -> Mesh:
    """Lat-long sphere with smooth vertex normals; 2*n_u*(n_v-1) triangles."""
    return displaced_blob(n_u, n_v, radius=radius, amplitude=0.0)


def displaced_blob(n_u: int, n_v: int, radius: float = 1.0, amplitude: float = 0.25,
                   seed: int = 0) -> Mesh:
    """A sphere displaced by a deterministic band of sinusoids: ``n_u``
    segments around, ``n_v`` rings from pole to pole, about
    2 * n_u * (n_v - 1) triangles (zero-area pole triangles dropped)."""
    rng = np.random.default_rng(seed)
    u = np.linspace(0.0, 2.0 * np.pi, n_u + 1)[:-1]
    v = np.linspace(0.0, np.pi, n_v + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")  # (n_u, n_v+1)

    r = np.full_like(uu, radius)
    if amplitude > 0:
        for _ in range(6):
            fu = rng.integers(1, 8)
            fv = rng.integers(1, 8)
            pu = rng.uniform(0, 2 * np.pi)
            pv = rng.uniform(0, 2 * np.pi)
            r = r + amplitude * radius / 6.0 * np.sin(fu * uu + pu) * np.sin(fv * vv + pv)

    x = r * np.sin(vv) * np.cos(uu)
    y = r * np.cos(vv)
    z = r * np.sin(vv) * np.sin(uu)
    pts = np.stack([x, y, z], axis=-1)  # (n_u, n_v+1, 3)

    # smooth normals by central differences on the parametric grid; du x dv
    # points outward for this parametrization, matching the winding below
    du = np.roll(pts, -1, axis=0) - np.roll(pts, 1, axis=0)
    dv = np.gradient(pts, axis=1)
    nrm = np.cross(du, dv)
    ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
    # poles degenerate (sin v = 0): fall back to the radial direction
    rad = np.linalg.norm(pts, axis=-1, keepdims=True)
    radial = pts / np.where(rad == 0, 1.0, rad)
    nrm = np.where(ln < 1e-12, radial, nrm / np.where(ln == 0, 1.0, ln))

    tris = []
    tnrm = []
    i0 = np.arange(n_u)
    i1 = (i0 + 1) % n_u
    for j in range(n_v):
        a, b = pts[i0, j], pts[i1, j]
        c, d = pts[i1, j + 1], pts[i0, j + 1]
        na, nb = nrm[i0, j], nrm[i1, j]
        nc, nd = nrm[i1, j + 1], nrm[i0, j + 1]
        tris.append(np.stack([a, b, c], axis=1))
        tnrm.append(np.stack([na, nb, nc], axis=1))
        tris.append(np.stack([a, c, d], axis=1))
        tnrm.append(np.stack([na, nc, nd], axis=1))
    v_arr = np.concatenate(tris)
    n_arr = np.concatenate(tnrm)
    area = np.linalg.norm(np.cross(v_arr[:, 1] - v_arr[:, 0], v_arr[:, 2] - v_arr[:, 0]), axis=-1)
    keep = area > 1e-12
    return Mesh(v_arr[keep], n_arr[keep])
