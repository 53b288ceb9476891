"""`BENCHMARK.json` and the files it names, found by name: a cell's
configuration (`configs/<config>.json`) and scene builder
(`scenes/<config>.py`), its traffic mix (`traffic/<traffic>.json`) and
the loop the mix names (`traffic/<loop>.py`), its check
(`checks/<cell>.json`) and the reference module the check names
(`reference/<reference>.py`), and each metric's reader
(`metrics/<metric>.py`)."""

from __future__ import annotations

import importlib
import json
import os

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(PERFBENCH)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root: str = CHECKOUT) -> dict:
    return load_json(root, "BENCHMARK.json")


def module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module of the ``perfbench``
    package (a name may hold dots: the file is loaded by its path)."""
    path = os.path.join(PERFBENCH, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    modname = f"perfbench.{kind}.{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench: dict, name: str) -> dict:
    """The workload ``name`` with everything it names: its configuration,
    traffic, check, and its end-to-end and per-layer metrics."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]

    def applies(metric):
        return name in metric.get("workloads", [name])

    return {
        "workload": w,
        "config": load_json(PERFBENCH, "configs", w["config"] + ".json"),
        "traffic": load_json(PERFBENCH, "traffic", w["traffic"] + ".json"),
        "check": load_json(PERFBENCH, "checks", name + ".json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }
