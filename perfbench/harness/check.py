"""What decides ``correct``: the samples that the timed path put into the
buffer at watched pixels, against the plain reference's radiance of the
same (pixel, sample) pairs.

The compared number is ``mismatch_share``: of the compared samples that
are not black on both sides, the share whose value differs from the
reference's by more than ``atol + rtol * |reference|`` in some channel (a
non-finite sample always differs). Black samples on both sides (a path
that found no light) agree trivially and are left out of the share. Two
float32 renderers of the same paths agree to rounding, except where
rounding turns a path (a ray that grazes an edge, a roulette draw at its
threshold); those few samples are what the limit allows.
"""

from __future__ import annotations

import numpy as np


def watch_pixels(seed: int, n_pixels: int, count: int) -> np.ndarray:
    """The pixels whose samples the window keeps, drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    return np.sort(rng.choice(n_pixels, size=min(count, n_pixels), replace=False))


def pairs(watched: np.ndarray, pixels: np.ndarray, first_sample: int, seed: int, cap: int):
    """The compared (pixel, sample index) pairs and the program's value of
    each: the watched sums' difference across each one-sample pass. At
    most ``cap`` pairs, drawn from the seed."""
    per_pass = np.diff(watched, axis=0)  # (passes, pixels, 3)
    n_pass = per_pass.shape[0]
    pass_i, pix_i = np.meshgrid(np.arange(n_pass), np.arange(len(pixels)), indexing="ij")
    pass_i, pix_i = pass_i.ravel(), pix_i.ravel()
    if len(pass_i) > cap:
        keep = np.sort(np.random.default_rng([seed, 2]).choice(len(pass_i), cap, replace=False))
        pass_i, pix_i = pass_i[keep], pix_i[keep]
    return pixels[pix_i], first_sample + pass_i, per_pass[pass_i, pix_i]


def mismatch_share(program: np.ndarray, reference: np.ndarray, rtol: float, atol: float) -> float:
    program = np.asarray(program, np.float64)
    reference = np.asarray(reference, np.float64)
    with np.errstate(invalid="ignore"):
        off = ~(np.abs(program - reference) <= atol + rtol * np.abs(reference))
    lit = (program != 0.0).any(-1) | (reference != 0.0).any(-1)
    return float(off.any(-1)[lit].mean()) if lit.any() else 1.0


def worst_relative_gap(program: np.ndarray, reference: np.ndarray) -> float | None:
    """The largest gap over the reference's value, in any channel of the
    answers not black on both sides (for the readings, not the check)."""
    program = np.asarray(program, np.float64)
    reference = np.asarray(reference, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        gap = np.abs(program - reference) / np.abs(reference)
    gap = gap[np.isfinite(gap)]
    return float(gap.max()) if gap.size else None
