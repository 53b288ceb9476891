#!/usr/bin/env python3
"""Run one cell of the benchmark of rpt_tpu_torch (`BENCHMARK.json`).

    python3 perfbench/run.py --workload lampshade.pathtrace --seed 7 --seconds 51 --trace 0

Everything the cell needs is found by name from `BENCHMARK.json`: its
configuration and scene builder, its traffic mix and the loop that the
mix names, its check and the reference module that the check names, and
its metrics' readers. The scene is made from ``--seed`` and handed to the
port; set-up (imports, CUDA, the scene, the port's build and warm-up of
the cell's own shape) is timed as ``setup_s``; the traffic then runs for
``--seconds``; with ``--trace 1`` under `torch.profiler`, for the
per-layer metrics. After the window the program's state is freed and the
plain reference (`perfbench/reference`) recomputes the compared answers.
The last line of standard output is the result, one JSON object; the
numbers compared are the last lines of standard error. The port's
`Renderer` is built by the scene module's own ``build_renderer`` where it
has one, else by `port_scene.build_renderer` (`port_scene.builder`).

The run needs a card (`torch.cuda.is_available()`), and neither JAX nor
the JAX package may be loaded: either fault ends it with no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(CHECKOUT, ".perfbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "rpt_tpu")


def forbidden_modules(modules=None) -> list:
    """The modules of JAX or the JAX package that are loaded, by whole
    top-level name (``rpt_tpu_torch`` is not ``rpt_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def _environment():
    """Every compile cache at a fixed directory inside the checkout, and
    one host thread for the math libraries: the window is one process
    launching kernels, and idle pool threads only add jitter."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def _fail(msg: str, code: int) -> int:
    print(f"perfbench: {msg}", file=sys.stderr)
    return code


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def execute(argv=None, device: str = "cuda", overrides: dict | None = None,
            readings: bool = False, control: bool = False):
    """One run: ``(exit code, result)``, the result None where the run
    gives none. ``device`` and ``overrides`` (merged into the cell's
    configuration) are for the CPU tests, which drive a run at a tiny size
    without a card; the command line always runs on the card. ``readings``
    (for `calibrate.py` only) adds the program's widest relative gap and,
    with ``control``, the lower-precision control computed in the
    program's place and read against the reference."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    if CHECKOUT not in sys.path:
        sys.path.insert(0, CHECKOUT)
    from perfbench.harness import check, port_scene, spec, trace

    cell = spec.cell(spec.benchmark(), args.workload)
    work, params, chk = cell["workload"], cell["traffic"], cell["check"]
    config = _merge(cell["config"], overrides)
    metrics = cell["per_layer"] if args.trace else cell["end_to_end"]
    readers = {m["name"]: spec.module("metrics", m["name"]) for m in metrics}
    loop = spec.module("traffic", params["loop"])
    reference = spec.module("reference", chk["reference"])

    import torch

    torch.set_num_threads(1)
    if device == "cuda" and not torch.cuda.is_available():
        return _fail("no card: torch.cuda.is_available() is False", 2), None
    if device == "cuda" and torch.cuda.device_count() < work["chips"]:
        return _fail(f"{work['name']} needs {work['chips']} cards, "
                     f"{torch.cuda.device_count()} found", 2), None

    settings = config["settings"][params["settings"]] if params.get("settings") else None
    scene = spec.module("scenes", work["config"])
    desc = scene.describe(config, settings, args.seed)
    renderer = port_scene.builder(scene)(desc, args.seed, device)
    renderer.compiled  # the scene compiled: SAH build, packing, upload
    loop.warm_up(renderer, desc, params)
    captured = {}
    restore = []
    if args.trace:
        for r in readers.values():
            for target, fn in getattr(r, "CAPTURE", {}).items():
                restore.append(_capture(target, fn, captured.setdefault(target, [])))
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    prof = None
    if args.trace and device == "cuda":
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    t_window = time.perf_counter()
    win = loop.run(renderer, desc, params, args.seconds, args.seed, chk)
    if device == "cuda":
        torch.cuda.synchronize()
    if prof is not None:
        prof.__exit__(None, None, None)
    for undo in restore:
        undo()
    rec = {"setup_s": t_window - T0, "window": win, "passes": len(win.calls_s),
           "captured": captured, "ops": [], "kernels": []}
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                   "count": work["chips"],
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
                   if device == "cuda" else 0}
    breakdown = None
    if prof is not None:
        rec["ops"] = trace.device_ops(prof)
        rec["kernels"] = trace.kernels(rec["ops"])
        rec["busy_s"] = trace.busy_s(rec["ops"])
        rec["traced_s"] = win.window_s
        device_info.update(busy_s=rec["busy_s"], window_s=win.window_s)
        breakdown = trace.breakdown(rec["ops"], win.ranges)
        del prof
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(rec)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    # the window is closed: free the program's state, then the reference
    del renderer
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    lanes, program = loop.answers(win, args.seed, chk)
    expected = loop.recompute(reference, desc, args.seed, lanes, device, torch.float32)
    t_ref = time.perf_counter() - t_ref
    mismatch = check.mismatch_share(program, expected, chk["rtol"], chk["atol"])
    compared = {"mismatch_share": {"value": mismatch, "limit": chk["limit"]},
                "failed": {"value": win.failed, "limit": 0},
                "non_finite_pixels": {"value": win.non_finite, "limit": 0}}
    correct = (all(c["value"] <= c["limit"] for c in compared.values())
               and len(win.calls_s) > 0)

    found = forbidden_modules()
    if found:
        return _fail(f"loaded in this process: {', '.join(found)}", 3), None
    for err in win.errors:
        print(f"perfbench: a call raised {err}", file=sys.stderr)
    result = {"correct": bool(correct), "attempted": win.attempted, "failed": win.failed,
              "metrics": values, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if readings:
        result["readings"] = {"worst_rel": check.worst_relative_gap(program, expected)}
        if control:
            low = loop.recompute(reference, desc, args.seed, lanes, device, torch.bfloat16)
            result["readings"]["control"] = check.mismatch_share(low, expected, chk["rtol"],
                                                                 chk["atol"])
    result["check"] = compared
    calls_ms = sorted(1e3 * c for c in win.calls_s) or [0.0]
    print(f"perfbench: set-up {rec['setup_s']:.2f} s; window {win.window_s:.2f} s, "
          f"{len(win.calls_s)} calls of {calls_ms[0]:.1f} / {calls_ms[len(calls_ms) // 2]:.1f} / "
          f"{calls_ms[-1]:.1f} ms (least / median / most); reference {t_ref:.1f} s for "
          f"{len(program)} answers", file=sys.stderr)
    for name, c in compared.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0, result


def main(argv=None, device: str = "cuda", overrides: dict | None = None) -> int:
    code, result = execute(argv, device, overrides)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


def _capture(target: str, fn, sink: list):
    """Wrap the function ``module.name`` of the program so that each call
    appends ``fn(args, kwargs, result)`` to ``sink``; returns the undo."""
    import importlib

    mod_name, attr = target.rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    original = getattr(mod, attr)

    def wrapped(*args, **kwargs):
        out = original(*args, **kwargs)
        sink.append(fn(args, kwargs, out))
        return out

    wrapped.__dict__.update(original.__dict__)  # counters such as ``launches`` stay readable
    setattr(mod, attr, wrapped)

    def undo():
        original.__dict__.update(wrapped.__dict__)
        setattr(mod, attr, original)

    return undo


if __name__ == "__main__":
    sys.exit(main())
