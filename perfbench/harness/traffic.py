"""What every traffic loop shares. A traffic mix (`traffic/<mix>.json`)
names its ``loop``; the loop is its own module, `traffic/<loop>.py`,
found by that name, with four functions:

* ``warm_up(renderer, desc, params)``: the mix's settings applied and its
  shapes run once (set-up);
* ``run(renderer, desc, params, seconds, seed, chk) -> Window``: a closed
  loop that starts no call after ``seconds`` and finishes and counts the
  one in flight, keeping what the check needs of each call's answer;
* ``answers(win, seed, chk) -> (lanes, program)``: the answers compared,
  drawn from the seed, and what the program gave for each;
* ``recompute(reference, desc, seed, lanes, device, dtype)``: the same
  answers from the plain reference module that the cell's check names.
"""

from __future__ import annotations

import time


class Window:
    """What a loop did in the measured window."""

    def __init__(self):
        self.calls_s = []  # host seconds of each call
        self.ranges = []  # (label, start_ns, end_ns) of each call, Unix epoch
        self.attempted = 0
        self.failed = 0
        self.errors = []
        self.window_s = 0.0
        self.samples = 0  # pixel samples completed
        self.non_finite = 0  # pixels of the image(s) that are not finite
        self.phases = []  # per call, the program's own phase seconds where it keeps them
        self.kept = {}  # what the loop keeps for its check


def closed_loop(seconds: float, call, label: str) -> Window:
    """``call(win)`` again and again until ``seconds`` have passed; a call
    that raises is counted as failed and ends the loop."""
    win = Window()
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        win.attempted += 1
        n0, t0 = time.time_ns(), time.perf_counter()
        try:
            call(win)
        except Exception as exc:
            win.failed += 1
            win.errors.append(repr(exc))
            break
        win.calls_s.append(time.perf_counter() - t0)
        win.ranges.append((label, n0, time.time_ns()))
    win.window_s = time.perf_counter() - t_start
    return win
