"""The port's kernel layer is a layer: the modules under
`rpt_tpu_torch/ops/` and `rpt_tpu_torch/accel/` import nothing above them
(the intersection queries, the integrators, the renderer, the scene, the
parallel drivers), and no package import inside a function; `tracing.py`,
which every layer counts into, imports nothing from the package. Each
module's syntax tree is walked, function bodies included. And the one
launch path, `ops._build.launch`, with a stub in place of the kernel
library: it calls the entry on the tensor's current stream, counts the
launch under the wrapper's name (`tracing.LAUNCHES`, read by a span) and
then raises on a non-zero status.

This file imports neither jax nor rpt_tpu.
"""

import ast
import collections
import glob
import os
from types import SimpleNamespace

import pytest
import torch

from rpt_tpu_torch import tracing
from rpt_tpu_torch.ops import _build

PKG = "rpt_tpu_torch"
PKG_DIR = os.path.join(os.path.dirname(__file__), "..", PKG)
ABOVE = ("intersect", "integrators", "renderer", "scene", "parallel")
MODULES = sorted(os.path.relpath(p, PKG_DIR).replace(os.sep, "/")
                 for p in (glob.glob(os.path.join(PKG_DIR, "ops", "*.py"))
                           + glob.glob(os.path.join(PKG_DIR, "accel", "*.py"))
                           + [os.path.join(PKG_DIR, "tracing.py")]))


def _package_imports(path: str, root: str = PKG_DIR):
    """``(module, in_function)`` for every import of the package in the
    file ``path`` under ``root``, relative imports resolved; ``from . import
    x`` gives an entry for x, which may be a module."""
    parts = [PKG, *path[:-3].split("/")]
    with open(os.path.join(root, path)) as f:
        tree = ast.parse(f.read())
    found = []

    def visit(node, in_function):
        if isinstance(node, ast.Import):
            found.extend((a.name, in_function) for a in node.names
                         if a.name.split(".")[0] == PKG)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = ".".join(parts[:len(parts) - node.level])
                mod = f"{base}.{node.module}" if node.module else base
            else:
                mod = node.module
            if mod.split(".")[0] == PKG:
                if node.module:
                    found.append((mod, in_function))
                found.extend((f"{mod}.{a.name}", in_function) for a in node.names)
        inner = in_function or isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                                 ast.Lambda))
        for child in ast.iter_child_nodes(node):
            visit(child, inner)

    visit(tree, False)
    return found


def _faults(path: str, root: str = PKG_DIR) -> list:
    imports = _package_imports(path, root)
    faults = [f"imports {m}, a layer above" for m, _ in imports
              if m.count(".") and m.split(".")[1] in ABOVE]
    faults += [f"imports {m} inside a function" for m, inner in imports if inner]
    if path == "tracing.py":
        faults += [f"imports {m} from the package" for m, _ in imports]
    return faults


@pytest.mark.parametrize("module", MODULES)
def test_kernel_layer_imports_only_downward(module):
    assert not _faults(module), f"{module}: {_faults(module)}"


def test_the_walk_finds_upward_and_nested_imports(tmp_path):
    """The walk itself: a module that imports `scene` at its top and
    `intersect` inside a function is seen doing both."""
    (tmp_path / "ops").mkdir()
    (tmp_path / "ops" / "probe.py").write_text(
        "from .. import scene\n\n\ndef f():\n    from ..intersect import closest_hit\n")
    assert sorted(_faults("ops/probe.py", str(tmp_path))) == [
        f"imports {PKG}.intersect inside a function",
        f"imports {PKG}.intersect, a layer above",
        f"imports {PKG}.intersect.closest_hit inside a function",
        f"imports {PKG}.intersect.closest_hit, a layer above",
        f"imports {PKG}.scene, a layer above",
    ]


def test_launch_counts_under_the_wrappers_name_then_checks(monkeypatch):
    calls = []
    codes = iter([0, 700])

    def entry(*args):
        calls.append(args)
        return next(codes)

    monkeypatch.setattr(_build, "library",
                        lambda: SimpleNamespace(lib=SimpleNamespace(rpt_probe=entry)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(tracing, "LAUNCHES", collections.Counter())
    on = torch.zeros(1)
    tracing.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with tracing.span("probe"):
                _build.launch("probe_hit", "rpt_probe", on, 1, 2)
                with pytest.raises(RuntimeError, match="probe_hit: .*cudaError 700"):
                    _build.launch("probe_hit", "rpt_probe", on, 3)
        (span,) = tracing.spans()
    finally:
        tracing.clear()
    assert calls == [(1, 2, 7), (3, 7)]  # the entry's arguments, then the stream
    assert tracing.LAUNCHES == {"probe_hit": 2}  # the failed launch counted too
    assert span.launches == {"probe_hit": 2}
