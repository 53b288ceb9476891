"""Seconds of a render's camera pass: the mean over the window's renders
of the program's own `Renderer.phase_seconds["trace"]` (host clock after
a device synchronisation)."""

PHASE = "trace"


def read(rec):
    times = [p[PHASE] for p in rec["window"].phases if PHASE in p]
    return sum(times) / len(times) if times else None
