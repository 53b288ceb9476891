"""The ``renders`` loop: whole photon-mapping renders back to back, as an
example program runs one, each with a seed of its own drawn from the
run's seed and its index. The render's settings (integrator, samples,
photons, gather sizes, watts) are the configuration's, as the scene
builder puts them under ``desc["render"]``.

After each render the image's values at the watched pixels (drawn from
the seed) and the program's own phase times are kept. A render that
raised, or whose image has a pixel that is not finite, counts as failed.
"""

from __future__ import annotations

import numpy as np

from perfbench.harness import check
from perfbench.harness.traffic import closed_loop

METHODS = {"point_beam": "photon_point_query_beam_render",
           "photon_map": "photon_map_render",
           "beam_beam": "photon_beam_query_beam_render"}
M63 = (1 << 63) - 1


def render_seed(seed: int, index: int) -> int:
    """The seed of the window's render ``index`` (-1: the warm-up's)."""
    return (int(seed) * 0x9E3779B1 + 0x632BE5AB * (index + 2)) & M63


def _configure(renderer, settings):
    renderer.num_samples(settings["samples"]).gather_size(settings["gather_size"])
    renderer.gather_size_volume(settings["gather_size_volume"])
    # the examples scale the light's watts by the photon count
    renderer.watts(settings["watts"] * settings["photons"])


def _render(renderer, settings):
    return getattr(renderer, METHODS[settings["integrator"]])(settings["photons"])


def warm_up(renderer, desc, params):
    """One render of one sample at the full photon count: the shoot, the
    map build and a camera wavefront, every kernel and shape the window's
    renders use."""
    settings = desc["render"]
    _configure(renderer, dict(settings, samples=1))
    renderer.seed(render_seed(renderer.seed_, -1))
    _render(renderer, settings)
    _configure(renderer, settings)


def run(renderer, desc, params, seconds, seed, chk):
    settings = desc["render"]
    n_pix = renderer.width_ * renderer.height_
    watch = check.watch_pixels(seed, n_pix, chk["watch_pixels"])
    values = []

    def one_render(win):
        renderer.seed(render_seed(seed, win.attempted - 1))
        _render(renderer, settings)
        image = renderer._last_buffer.sum.reshape(-1, 3)
        values.append(image[watch].copy())
        win.phases.append(dict(renderer.phase_seconds))
        bad = int(np.count_nonzero(~np.isfinite(image).all(-1)))
        if bad:
            win.failed += 1
            win.non_finite += bad

    win = closed_loop(seconds, one_render, "render")
    win.samples = len(values) * settings["samples"] * n_pix
    win.kept = {"watch": watch, "values": values}
    return win


def chosen(seed: int, n_renders: int, count: int) -> list:
    """The renders compared: ``count`` of the ``n_renders`` completed,
    drawn from the seed."""
    rng = np.random.default_rng([seed, 3])
    return sorted(rng.choice(n_renders, size=min(count, n_renders), replace=False).tolist())


def answers(win, seed, chk):
    values, watch = win.kept["values"], win.kept["watch"]
    picks = chosen(seed, len(values), chk["renders"])
    lanes = [(render_seed(seed, i), watch) for i in picks]
    program = np.concatenate([values[i] for i in picks]) if picks else np.zeros((0, 3))
    return lanes, program


def recompute(reference, desc, seed, lanes, device, dtype):
    if not lanes:
        return np.zeros((0, 3))
    return np.concatenate([reference.render_pixels(desc, rs, pixels, device, dtype=dtype)
                           for rs, pixels in lanes])
