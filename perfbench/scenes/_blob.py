"""Frozen copy of `rpt_tpu_torch/meshes.py::displaced_blob` (`bench.py:84-91`'s dragon stand-in).

A sphere displaced by a band of six sinusoids drawn from ``seed``:
``n_u`` segments around, ``n_v`` rings from pole to pole, about
``2 * n_u * (n_v - 1)`` triangles (zero-area pole triangles dropped), with
smooth vertex normals. Returns ``(vertices, normals)``, each (n, 3, 3)
float64.
"""

from __future__ import annotations

import numpy as np


def displaced_blob(n_u: int, n_v: int, seed: int, radius: float = 1.0,
                   amplitude: float = 0.25):
    rng = np.random.default_rng(seed)
    u = np.linspace(0.0, 2.0 * np.pi, n_u + 1)[:-1]
    v = np.linspace(0.0, np.pi, n_v + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")  # (n_u, n_v+1)

    r = np.full_like(uu, radius)
    for _ in range(6):
        fu = rng.integers(1, 8)
        fv = rng.integers(1, 8)
        pu = rng.uniform(0, 2 * np.pi)
        pv = rng.uniform(0, 2 * np.pi)
        r = r + amplitude * radius / 6.0 * np.sin(fu * uu + pu) * np.sin(fv * vv + pv)

    pts = np.stack([r * np.sin(vv) * np.cos(uu), r * np.cos(vv), r * np.sin(vv) * np.sin(uu)],
                   axis=-1)  # (n_u, n_v+1, 3)

    # smooth normals by central differences on the parametric grid; du x dv
    # points outward, matching the winding below; the poles take the radial
    du = np.roll(pts, -1, axis=0) - np.roll(pts, 1, axis=0)
    dv = np.gradient(pts, axis=1)
    nrm = np.cross(du, dv)
    ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
    rad = np.linalg.norm(pts, axis=-1, keepdims=True)
    radial = pts / np.where(rad == 0, 1.0, rad)
    nrm = np.where(ln < 1e-12, radial, nrm / np.where(ln == 0, 1.0, ln))

    i0 = np.arange(n_u)
    i1 = (i0 + 1) % n_u
    a, b = pts[i0, :-1], pts[i1, :-1]  # (n_u, n_v, 3): ring j and its neighbour
    c, d = pts[i1, 1:], pts[i0, 1:]
    na, nb, nc, nd = nrm[i0, :-1], nrm[i1, :-1], nrm[i1, 1:], nrm[i0, 1:]
    # ring by ring, the two triangles of each quad in turn (the original's order)
    tri = np.stack([np.stack([a, b, c], axis=2), np.stack([a, c, d], axis=2)], axis=2)
    tnrm = np.stack([np.stack([na, nb, nc], axis=2), np.stack([na, nc, nd], axis=2)], axis=2)
    v_arr = tri.transpose(1, 2, 0, 3, 4).reshape(-1, 3, 3)
    n_arr = tnrm.transpose(1, 2, 0, 3, 4).reshape(-1, 3, 3)
    area = np.linalg.norm(np.cross(v_arr[:, 1] - v_arr[:, 0], v_arr[:, 2] - v_arr[:, 0]), axis=-1)
    keep = area > 1e-12
    return v_arr[keep], n_arr[keep]
