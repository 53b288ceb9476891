"""K-rng launches a pass (program span): every ``threefry_*``
wrapper's launches over the window's ``sample`` spans, over their
number."""

from perfbench.harness import spans as sp


def read(rec):
    spans = sp.recorded()
    roots = sp.named(spans, "sample") if spans else []
    if not roots:
        return None
    return sum(n for r in roots for fn, n in r.launches.items()
               if fn.startswith("threefry_")) / len(roots)
