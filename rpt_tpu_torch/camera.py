"""Thin-lens perspective camera — port of `rpt_tpu/camera.py`
(`rpt/src/camera.rs`).

The camera is host-side scene description (plain floats); ``cast_ray``
maps NDC coordinates and per-lane RNG keys to a primary-ray wavefront on
the device of its inputs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np

from . import sampling
from .ray import Ray
from .vec import Vec3


def _normalize(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


@dataclass(frozen=True)
class Camera:
    """Defaults per camera.rs:29-40: eye (0,0,10), facing -z, y-up,
    fov pi/6, no depth of field."""

    eye: tuple = (0.0, 0.0, 10.0)
    direction: tuple = (0.0, 0.0, -1.0)
    up: tuple = (0.0, 1.0, 0.0)
    fov: float = math.pi / 6.0
    aperture: float = 0.0
    focal_distance: float = 0.0

    @staticmethod
    def look_at(eye, center, up, fov: float) -> "Camera":
        """camera.rs:44-55 — re-orthogonalizes `up` against the view dir."""
        eye = np.asarray(eye, np.float64)
        direction = _normalize(np.asarray(center, np.float64) - eye)
        up = np.asarray(up, np.float64)
        up = _normalize(up - np.dot(up, direction) * direction)
        return Camera(tuple(eye), tuple(direction), tuple(up), fov)

    def focus(self, focal_point, aperture: float) -> "Camera":
        """camera.rs:58-62."""
        fp = np.asarray(focal_point, np.float64)
        fd = float(np.dot(fp - np.asarray(self.eye, np.float64),
                          np.asarray(self.direction, np.float64)))
        return replace(self, focal_distance=fd, aperture=aperture)

    def cast_ray(self, x, y, keys) -> Ray:
        """Cast a batch of rays; (x, y) are (N,) tensors normalized to
        [-1, 1] (camera.rs:65-82). ``keys`` (an (N, 2) key batch or a
        `sampling.KeyPath`) is used only when aperture > 0."""
        dev = x.device
        d = 1.0 / math.tan(self.fov / 2.0)
        direction = _normalize(self.direction)
        up = np.asarray(self.up, np.float64)
        right = _normalize(np.cross(direction, up))

        fwd = Vec3.of(*direction, device=dev)
        rgt = Vec3.of(*right, device=dev)
        upv = Vec3.of(*up, device=dev)

        origin = Vec3.of(*self.eye, device=dev).broadcast_to(x.shape)
        new_dir = fwd * d + rgt * x + upv * y
        if self.aperture > 0.0:
            focal_point = origin + new_dir.normalize() * self.focal_distance
            r1, r2 = sampling.uniform2(sampling.fold(keys, 0xD0F))
            dx, dy = sampling.unit_disc(r1, r2)
            origin = origin + (rgt * dx + upv * dy) * self.aperture
            new_dir = focal_point - origin
        return Ray(origin, new_dir.normalize())
