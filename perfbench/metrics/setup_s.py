"""Seconds from the start of the process to the start of the window:
imports, CUDA, the scene made and compiled (the SAH build and packing),
the port's kernels loaded (built on a checkout's first run) and one
warm-up call of the cell's shape."""


def read(rec):
    return rec["setup_s"]
