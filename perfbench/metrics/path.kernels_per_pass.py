"""CUDA kernels launched a pass over the traced window (profiler count)."""


def read(rec):
    if not rec["kernels"] or not rec["passes"]:
        return None
    return len(rec["kernels"]) / rec["passes"]
