"""Accumulation buffer, variance metric, and box filter (numpy copy of
`rpt_tpu/buffer.py`).

Parity: `rpt/src/buffer.rs`. The reference stores *every*
sample per pixel (`samples: Vec<Vec<Color>>`); an (E[x], E[|x|^2], n)
moment accumulator reproduces both the image and the n-1-dof variance in
O(1) memory — this is also what makes progressive checkpoint/resume cheap
(see `Buffer.state_dict`). Host-side numpy in f64 (accumulation precision).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .color import color_bytes


@dataclass(frozen=True)
class Filter:
    """Noise-reduction filter (buffer.rs:97-108): Box(radius); radius 0 is
    a no-op."""

    radius: int = 0

    @staticmethod
    def Box(radius: int) -> "Filter":
        return Filter(int(radius))


class Buffer:
    """Accumulates per-call pixel samples. ``add_samples`` adds one sample
    per pixel (as each ``Renderer::sample`` call does, buffer.rs:32-40)."""

    def __init__(self, width: int, height: int, filter: Filter = Filter()):
        self.width = int(width)
        self.height = int(height)
        self.filter = filter
        self.sum = np.zeros((self.height, self.width, 3), np.float64)
        self.sum_sq = np.zeros((self.height, self.width), np.float64)
        self.num_samples = 0

    def add_samples(self, colors: np.ndarray):
        """Add a full-frame (H, W, 3) sample matrix."""
        colors = np.asarray(colors).astype(np.float64, copy=False)
        assert colors.shape == (self.height, self.width, 3), "Invalid sample dimension"
        self.sum += colors
        self.sum_sq += (colors * colors).sum(-1)
        self.num_samples += 1

    def variance(self) -> float:
        """Mean per-pixel sample variance with n-1 dof (buffer.rs:59-73)."""
        n = self.num_samples
        if n < 2:
            return float("nan")
        mean = self.sum / n
        ss = self.sum_sq - n * (mean * mean).sum(-1)
        return float(np.mean(ss / (n - 1)))

    def image(self) -> np.ndarray:
        """Filtered sRGB u8 image (buffer.rs:43-56)."""
        assert self.num_samples > 0, "Pixel found with no samples"
        mean = self._filtered()
        return color_bytes(mean)

    def raw(self) -> np.ndarray:
        """Filtered linear radiance (H, W, 3) — for pixel-diff tests."""
        assert self.num_samples > 0
        return self._filtered()

    def _filtered(self) -> np.ndarray:
        r = self.filter.radius
        if r == 0:
            return self.sum / self.num_samples
        # Box(radius): average of all samples in the (2r+1)^2 neighborhood,
        # clipped at the image border (buffer.rs:75-93) — per-sample
        # weighting, via integral images.
        s = _box_sum(self.sum, r)
        counts = _box_sum(np.full((self.height, self.width, 1), float(self.num_samples)), r)
        return s / counts

    # -- progressive checkpoint/resume (reference keeps the buffer only in
    # memory; crash loses it — renderer.rs:144-156) ------------------------
    def state_dict(self) -> dict:
        return {
            "sum": self.sum,
            "sum_sq": self.sum_sq,
            "num_samples": self.num_samples,
            "width": self.width,
            "height": self.height,
            "radius": self.filter.radius,
        }

    @staticmethod
    def from_state_dict(state: dict) -> "Buffer":
        buf = Buffer(state["width"], state["height"], Filter(int(state["radius"])))
        buf.sum = np.asarray(state["sum"], np.float64)
        buf.sum_sq = np.asarray(state["sum_sq"], np.float64)
        buf.num_samples = int(state["num_samples"])
        return buf

    def save(self, path: str):
        np.savez(path, **self.state_dict())

    @staticmethod
    def load(path: str) -> "Buffer":
        with np.load(path) as z:
            return Buffer.from_state_dict({k: z[k] for k in z.files})


def _box_sum(img: np.ndarray, r: int) -> np.ndarray:
    """Sum over the clipped (2r+1)^2 neighborhood via integral image."""
    h, w = img.shape[:2]
    ii = np.zeros((h + 1, w + 1) + img.shape[2:], np.float64)
    ii[1:, 1:] = img.cumsum(0).cumsum(1)
    y = np.arange(h)
    x = np.arange(w)
    y0 = np.clip(y - r, 0, h)
    y1 = np.clip(y + r + 1, 0, h)
    x0 = np.clip(x - r, 0, w)
    x1 = np.clip(x + r + 1, 0, w)
    return ii[y1[:, None], x1[None, :]] - ii[y0[:, None], x1[None, :]] - ii[
        y1[:, None], x0[None, :]
    ] + ii[y0[:, None], x0[None, :]]
