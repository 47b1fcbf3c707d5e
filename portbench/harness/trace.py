"""The traced slice: ``torch.profiler`` over a fixed number of calls after
the measured window, reduced in memory to what the per-layer readers need.

- ``busy_s``: the union of every device interval (kernels, copies, memsets);
- ``window_s``: the slice's host wall time, which ends in a synchronise;
- ``kernels``: device seconds by kernel name;
- ``idle``: each gap between device intervals inside the slice, labelled by
  the deepest host span (a profiler op or one of the benchmark's
  ``record_function`` spans) open at its midpoint.

No file is written.
"""

from __future__ import annotations

import heapq
import time
from collections import defaultdict
from typing import Callable, Dict

import torch

WINDOW_SPAN = "portbench.slice"
PROFILER_OWN = {"Activity Buffer Request"}  # the profiler's own host work


def _union(intervals):
    """Sorted, merged ``(start, end)`` pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label_gaps(gaps, host):
    """For each gap ``(start, end)``, the name of the shortest host span
    that covers its midpoint ("python" where none does)."""
    host = sorted(host)
    out, active, i = [], [], 0
    for s, e in sorted(gaps):
        mid = 0.5 * (s + e)
        while i < len(host) and host[i][0] <= mid:
            hs, he, name = host[i]
            heapq.heappush(active, (he, hs, name))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        best = min(active, key=lambda a: a[0] - a[1], default=None)
        out.append((best[2] if best else "python", e - s))
    return out


def reduce_events(events, wall_s: float) -> Dict:
    """The record of one profiled slice from ``prof.events()``."""
    from torch.autograd import DeviceType

    device, host, kernels, ops = [], [], defaultdict(float), []
    window = None
    for ev in events:
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            # a record_function span is mirrored on the device's timeline
            if getattr(ev, "is_user_annotation", False) or ev.name.startswith("portbench."):
                continue
            device.append((tr.start, tr.end))
            kernels[ev.name] += (tr.end - tr.start) * 1e-6
            ops.append((tr.start, ev.name, (tr.end - tr.start) * 1e-6))
        elif ev.device_type == DeviceType.CPU:
            if ev.name == WINDOW_SPAN:
                window = (tr.start, tr.end)
            elif tr.end > tr.start and ev.name not in PROFILER_OWN:
                host.append((tr.start, tr.end, ev.name))
    merged = _union(device)
    if window is None and merged:
        window = (merged[0][0], merged[-1][1])
    if window:  # the slice's own device time only
        merged = [[max(s, window[0]), min(e, window[1])] for s, e in merged
                  if e > window[0] and s < window[1]]
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps, at = [], window[0] if window else 0.0
    for s, e in merged:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if window and window[1] > at:
        gaps.append((at, window[1]))
    idle = defaultdict(float)
    for name, us in _label_gaps(gaps, host):
        idle[name] += us * 1e-6
    return {"window_s": wall_s, "busy_s": busy, "kernels": dict(kernels),
            "launches": [(name, d) for _, name, d in sorted(ops)],
            "idle": dict(idle)}


def traced(run_units: Callable[[], int], device) -> Dict:
    """Profile ``run_units()`` (which returns the units it completed) and
    reduce its trace."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW_SPAN):
            units = run_units()
            if cuda:
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    record = reduce_events(prof.events(), wall)
    record["units"] = units
    return record


def breakdown(record: Dict, top: int = 10) -> Dict:
    """The device operations that took the most time and the host activity
    behind the longest idle time, ``[[name, seconds], ...]``."""
    ops = sorted(record["kernels"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(record["idle"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[k[:120], v] for k, v in gaps]}


def kernel_seconds(record: Dict, *needles: str) -> float:
    """Device seconds of the kernels whose name holds any of ``needles``."""
    return sum(v for k, v in record["kernels"].items() if any(n in k for n in needles))


def seconds_following(record: Dict, name: str, after: str) -> float:
    """Device seconds of the launches of ``name`` that directly follow a
    launch of ``after`` (a shared kernel counted for the caller it ends)."""
    launches = record["launches"]
    return sum(d for (a, _), (b, d) in zip(launches, launches[1:])
               if after in a and name in b)
