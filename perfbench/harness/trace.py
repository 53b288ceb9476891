"""The traced run's device record: `torch.profiler` over the measured
window with CUDA activity only (host op events would cost minutes over a
window's 10^5-10^6 launches), reduced to the device operations
(name, start, end), in Unix nanoseconds as the profiler keeps them, and to
what the per-layer readers and ``breakdown`` need. The harness's own
ranges (each traffic call) are kept on the host clock of the same epoch
(`time.time_ns`), so an idle gap can be laid against what the host was
doing."""

from __future__ import annotations

import collections
import re

from . import stats

COPY = re.compile(r"^(Memcpy|Memset)")


def device_ops(prof) -> list:
    """(name, start_ns, end_ns) of every operation that ran on the card,
    sorted by start."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    return sorted(ops, key=lambda op: op[1])


def kernels(ops) -> list:
    """The kernels among the device operations (copies and fills left out)."""
    return [op for op in ops if not COPY.match(op[0])]


def busy_s(ops) -> float:
    return stats.union_length((s, e) for _, s, e in ops) / 1e9


def short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."


def breakdown(ops, ranges, top: int = 10) -> dict:
    """The device operations that took most time (by name), and the idle
    time of the card by what the host was doing: the harness range it was
    in (``ranges``: (label, start_ns, end_ns)) and the operation that ran
    last before the gap."""
    by_name = collections.Counter()
    for name, s, e in ops:
        by_name[short(name)] += (e - s) / 1e9
    gaps = collections.Counter()
    counts = collections.Counter()
    ranges = sorted(ranges, key=lambda r: r[1])
    r_i = 0
    end, last = None, None
    for name, s, e in ops:
        if end is not None and s > end:
            mid = (s + end) / 2
            while r_i < len(ranges) and ranges[r_i][2] < mid:
                r_i += 1
            inside = r_i < len(ranges) and ranges[r_i][1] <= mid
            label = f"{ranges[r_i][0] if inside else 'harness'}: after {short(last, 80)}"
            gaps[label] += (s - end) / 1e9
            counts[label] += 1
        if end is None or e > end:
            end, last = e, name
    return {
        "device_ops": [[n, v] for n, v in by_name.most_common(top)],
        "idle_gaps": [[f"{n} (x{counts[n]})", v] for n, v in gaps.most_common(top)],
    }
