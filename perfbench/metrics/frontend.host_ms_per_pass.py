"""Host milliseconds a pass in the front end (program span): the mean
over the window's `Renderer.sample` calls of their ``sample`` span less
their ``path.chunk`` children, so the camera wavefront and the Morton
pixel grid, the copy out to the host, the f64 cast and the buffer's
accumulation."""

from perfbench.harness import spans as sp


def read(rec):
    spans = sp.recorded()
    roots = sp.named(spans, "sample") if spans else []
    if not roots:
        return None
    return sum(sp.self_ns(r, spans, "path.chunk") for r in roots) / len(roots) / 1e6
