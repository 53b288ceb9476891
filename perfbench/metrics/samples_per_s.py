"""Millions of pixel samples completed in the window over the whole
window (host clock; the window ends when the call in flight at
``--seconds`` ends)."""


def read(rec):
    win = rec["window"]
    return win.samples / win.window_s / 1e6 if win.samples else None
