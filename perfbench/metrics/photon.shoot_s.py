"""Seconds of a render's photon shoot: the mean over the window's renders
of the program's own `Renderer.phase_seconds["shoot"]` (host clock after
a device synchronisation)."""

PHASE = "shoot"


def read(rec):
    times = [p[PHASE] for p in rec["window"].phases if PHASE in p]
    return sum(times) / len(times) if times else None
