"""The share of the card's idle time that falls inside the photon shoot
(program span): 100 x the idle time inside ``photon.shoot`` spans / all
the card's idle time in the window (the first render's start to the last
render's end; idle = the complement of the union of the device
operations' intervals)."""

from perfbench.harness import spans as sp


def read(rec):
    return sp.idle_share_in(rec, "photon.shoot")
