"""Tracing / profiling instrumentation (counterpart of
``voxactb_tpu/utils/profiling.py``).

Structured step timers feeding a log writer, an optional ``torch.profiler``
trace context, and host resource gauges (psutil, optional).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class StepTimer:
    """Named wall-clock accumulators with EMA; cheap enough for the hot loop."""

    def __init__(self, ema: float = 0.98):
        self._ema = ema
        self._avg: Dict[str, float] = {}
        self._last: Dict[str, float] = {}
        self._counts = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._last[name] = dt
            self._counts[name] += 1
            prev = self._avg.get(name)
            self._avg[name] = dt if prev is None else (
                self._ema * prev + (1 - self._ema) * dt)

    def last(self, name: str) -> float:
        return self._last.get(name, 0.0)

    def summary(self) -> Dict[str, float]:
        return {f"time/{k}_s": v for k, v in self._avg.items()}


@contextlib.contextmanager
def device_trace(logdir: Optional[str], device=None):
    """A ``torch.profiler`` trace of the block when a logdir is given: host
    activity, and CUDA activity when ``device`` is a CUDA device (default:
    when CUDA is available). Writes a Chrome trace (``trace_<pid>_<n>.json``,
    open it in Perfetto or chrome://tracing) into ``logdir``; yields the
    profiler (None without a logdir)."""
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:  # the block's kernels end inside the window
                torch.cuda.synchronize(device)
    n = len([f for f in os.listdir(logdir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


def host_gauges() -> Dict[str, float]:
    """psutil memory/CPU gauges (offline_train_runner.py:127-155)."""
    out: Dict[str, float] = {}
    try:
        import psutil

        # one cached Process: cpu_percent(interval=None) diffs against the
        # PREVIOUS call on the same instance — a fresh instance per call
        # returns a meaningless 0.0 forever
        global _PSUTIL_PROC
        if _PSUTIL_PROC is None:
            _PSUTIL_PROC = psutil.Process()
        out["host/rss_gb"] = _PSUTIL_PROC.memory_info().rss / 1e9
        out["host/cpu_percent"] = _PSUTIL_PROC.cpu_percent(interval=None)
        vm = psutil.virtual_memory()
        out["host/mem_used_frac"] = vm.percent / 100.0
    except ImportError:
        pass
    return out


_PSUTIL_PROC = None
