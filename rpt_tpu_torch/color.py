"""Color handling: sRGB <-> linear with gamma 2.2 (copy of
`rpt_tpu/color.py`, on the port's ``Vec3``).

Parity with `rpt/src/color.rs` — colors are linear-RGB triples;
``hex_color`` decodes an sRGB hex int with gamma 2.2, ``color_bytes``
clamps + encodes with gamma 1/2.2.
"""

from __future__ import annotations

import numpy as np

from .vec import Vec3

SRGB_GAMMA = 2.2


def hex_color(x: int) -> Vec3:
    """sRGB hex integer -> linear-intensity color (color.rs:10-15)."""
    r = ((x >> 16) & 0xFF) / 255.0
    g = ((x >> 8) & 0xFF) / 255.0
    b = (x & 0xFF) / 255.0
    return Vec3.of(r**SRGB_GAMMA, g**SRGB_GAMMA, b**SRGB_GAMMA)


def color_bytes(color: np.ndarray) -> np.ndarray:
    """Linear (..., 3) float -> clamped sRGB u8 (color.rs:18-24).

    Host-side (numpy). Matches the reference's trunc-toward-zero u8 cast;
    NaN radiance encodes as black, as Rust's f64::max(NaN, 0.0) does.
    """
    c = np.asarray(color, np.float64)
    c = np.clip(np.nan_to_num(c, nan=0.0), 0.0, 1.0)
    return (c ** (1.0 / SRGB_GAMMA) * 255.0).astype(np.uint8)
