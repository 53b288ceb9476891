"""The 95th percentile of the host time of every progressive pass of the
window, in milliseconds (each pass ends on the host, when its image
reaches the buffer)."""

from perfbench.harness import stats


def read(rec):
    calls = rec["window"].calls_s
    return stats.percentile(calls, 95) * 1e3 if calls else None
