"""Seconds a whole render: the whole window over the renders completed in
it (host clock; the window ends when the render in flight at
``--seconds`` ends, and that render counts)."""


def read(rec):
    win = rec["window"]
    return win.window_s / len(win.calls_s) if win.calls_s else None
