"""Environment lighting — port of `rpt_tpu/environment.py`
(`rpt/src/environment.rs`). Only the solid-color environment
is ported; the HDRI map is not yet."""

from __future__ import annotations

from dataclasses import dataclass

from .vec import Vec3


@dataclass(frozen=True)
class ColorEnvironment:
    """Solid-color environment (environment.rs:56-58); default black."""

    color: tuple = (0.0, 0.0, 0.0)

    def tables(self, device=None):
        return Vec3.of(*self.color, device=device)

    def get_color(self, tables, direction: Vec3) -> Vec3:
        return tables.broadcast_to(direction.shape)


Environment = ColorEnvironment
