"""Environment lighting — port of `rpt_tpu/environment.py`
(`rpt/src/environment.rs`): a solid colour, or an HDRI equirectangular
map sampled bilinearly with four torch gathers a lane."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .vec import Vec3, lerp, take


@dataclass(frozen=True)
class ColorEnvironment:
    """Solid-color environment (environment.rs:56-58); default black."""

    color: tuple = (0.0, 0.0, 0.0)

    def tables(self, device=None):
        return Vec3.of(*self.color, device=device)

    def get_color(self, tables, direction: Vec3) -> Vec3:
        return tables.broadcast_to(direction.shape)


class Hdri:
    """Equirectangular HDR environment (environment.rs:5-52)."""

    def __init__(self, buf):
        buf = np.asarray(buf, np.float64)
        if not (buf.ndim == 3 and buf.shape[2] == 3 and buf.shape[0] > 0 and buf.shape[1] > 0):
            raise ValueError(f"an HDRI is an (H, W, 3) image, not {buf.shape}")
        self.height, self.width = buf.shape[:2]
        self._buf = buf

    def tables(self, device=None) -> Vec3:
        """The map as a flat (H * W,) float32 `Vec3` on ``device``."""
        return Vec3.from_array(self._buf.reshape(-1, 3), device)

    def get_color(self, tables: Vec3, direction: Vec3) -> Vec3:
        """direction -> (azimuth, polar) -> bilinear sample
        (environment.rs:25-52). As the JAX package: x0, y0 truncated toward
        zero and clamped, and x0 + 1, y0 + 1 clamped to the last column and
        row (no wrap at the seam)."""
        d = direction.normalize()
        azimuth = torch.atan2(d.z, d.x) + math.pi
        polar = torch.acos(torch.clamp(d.y, -1.0, 1.0))
        x = azimuth / (2.0 * math.pi) * (self.width - 1)
        y = polar / math.pi * (self.height - 1)
        x0 = torch.clamp(x.to(torch.int32), 0, self.width - 1)
        y0 = torch.clamp(y.to(torch.int32), 0, self.height - 1)
        x1 = torch.clamp(x0 + 1, max=self.width - 1)
        y1 = torch.clamp(y0 + 1, max=self.height - 1)
        ax = x - x0.to(x.dtype)
        ay = y - y0.to(y.dtype)

        def fetch(yy, xx):
            return take(tables, (yy * self.width + xx).long())

        top = lerp(fetch(y0, x0), fetch(y0, x1), ax)
        bot = lerp(fetch(y1, x0), fetch(y1, x1), ax)
        return lerp(top, bot, ay)


Environment = ColorEnvironment | Hdri
