"""The ``passes`` loop: progressive one-sample passes, ``Renderer.sample(1,
buffer)`` again and again into one buffer, the sample indices continuing
(`Renderer::iterative_render`, `cornell.rs:87-106`).

After each pass the buffer's sums at the watched pixels (drawn from the
seed) are kept, so the check can compare every pass's sample there. A
pass that raised, or after which more watched pixels are not finite,
counts as failed; the whole image is looked at once, after the window
(where it holds a pixel that is not finite and no pass was counted, one
is).
"""

from __future__ import annotations

import numpy as np

from perfbench.harness import check
from perfbench.harness.traffic import closed_loop

FIRST_SAMPLE = 1  # the warm-up pass traced sample 0


def warm_up(renderer, desc, params):
    import rpt_tpu_torch as rpt

    renderer.sample(1, rpt.Buffer(renderer.width_, renderer.height_))


def run(renderer, desc, params, seconds, seed, chk):
    import rpt_tpu_torch as rpt

    w, h = renderer.width_, renderer.height_
    buffer = rpt.Buffer(w, h)
    watch = check.watch_pixels(seed, w * h, chk["watch_pixels"])
    rows, cols = watch // w, watch % w
    snaps = [np.zeros((len(watch), 3))]
    bad = [0]  # watched pixels not finite

    def one_pass(win):
        renderer.sample(1, buffer)
        snap = buffer.sum[rows, cols]
        snaps.append(snap)
        now = int(np.count_nonzero(~np.isfinite(snap).all(-1)))
        if now > bad[0]:
            bad[0] = now
            win.failed += 1

    win = closed_loop(seconds, one_pass, "pass")
    win.samples = len(win.calls_s) * w * h
    win.non_finite = int(np.count_nonzero(~np.isfinite(buffer.sum).all(-1)))
    if win.non_finite > bad[0] and not win.failed:
        win.failed += 1  # some pass of the window made them, at pixels not watched
    win.kept = {"watch": watch, "watched": np.stack(snaps)}
    return win


def answers(win, seed, chk):
    pixels, samples, program = check.pairs(win.kept["watched"], win.kept["watch"], FIRST_SAMPLE,
                                           seed, chk["pairs"])
    return (pixels, samples), program


def recompute(reference, desc, seed, lanes, device, dtype):
    pixels, samples = lanes
    if not len(pixels):
        return np.zeros((0, 3))
    return reference.radiance(desc, seed, pixels, samples, device, dtype=dtype)
