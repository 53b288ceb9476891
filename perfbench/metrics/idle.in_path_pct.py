"""The share of the card's idle time that falls inside the path tracer's
levels (program span): 100 x the idle time inside ``path.level`` spans /
all the card's idle time in the window (the first call's start to the
last call's end; idle = the complement of the union of the device
operations' intervals)."""

from perfbench.harness import spans as sp


def read(rec):
    return sp.idle_share_in(rec, "path.level")
