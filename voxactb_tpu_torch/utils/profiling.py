"""Tracing / profiling instrumentation (counterpart of
``voxactb_tpu/utils/profiling.py``).

Spans and counters at the program's layer boundaries, kept in memory; an
optional ``torch.profiler`` trace context; host resource gauges (psutil,
optional).

- ``span(name, unit=None)`` times a block and ``count(name, n=1)`` adds to a
  counter. Tracing is on while a ``torch.profiler`` session records or a
  ``collect()`` block is open; off, each call reads two flags and returns at
  once (``span`` hands back one shared no-op context).
- On, a span adds its calls, total seconds, self seconds (total less what
  its child spans on the same thread cover), its parent's name and its
  thread to the current ``Collection``, and while a profiler records it is
  also a ``record_function`` on the profiler's host timeline, beside the
  device's kernels (``unit``, the act's or update's step, in its args).
  ``timeline=False`` keeps a span off that timeline: a background worker's
  spans would otherwise label the idle gaps of the thread it feeds.
- The current collection is the innermost open ``collect()``'s; with none
  open, a profiler session has one of its own, begun by the first span or
  count that finds the profiler recording after one that found it idle.
  ``last_collection()`` is the newest of either kind.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Iterator, Optional

from torch.autograd import profiler as _autograd_profiler


class Collection:
    """The spans and counts of one stretch of the program, by name. Each
    span's entry: ``calls``, ``total_s``, ``self_s``, and the ``parent``
    span's name and the ``thread`` of its first call."""

    def __init__(self):
        self._lock = threading.Lock()
        self.spans: Dict[str, dict] = {}
        self.counts: Dict[str, int] = {}

    def _add(self, name: str, total: float, own: float, parent: Optional[str],
             thread: str) -> None:
        with self._lock:
            entry = self.spans.get(name)
            if entry is None:
                self.spans[name] = {"calls": 1, "total_s": total, "self_s": own,
                                    "parent": parent, "thread": thread}
            else:
                entry["calls"] += 1
                entry["total_s"] += total
                entry["self_s"] += own

    def _count(self, name: str, n: int) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def calls(self, name: str) -> int:
        with self._lock:
            entry = self.spans.get(name)
            return entry["calls"] if entry else 0

    def seconds(self, name: str) -> float:
        """Total seconds of the span ``name`` (0 where it never ran)."""
        with self._lock:
            entry = self.spans.get(name)
            return entry["total_s"] if entry else 0.0

    def as_dict(self) -> dict:
        """``{"spans": {name: entry}, "counts": {name: n}}``, a copy."""
        with self._lock:
            return {"spans": {k: dict(v) for k, v in self.spans.items()},
                    "counts": dict(self.counts)}


_lock = threading.Lock()
_explicit: Optional[Collection] = None  # the innermost open collect()'s
_implicit: Optional[Collection] = None  # the recording profiler session's
_last: Optional[Collection] = None
_local = threading.local()  # .stack: this thread's open spans


def _session_ended() -> None:
    """A span or count found the profiler idle: the session's collection is
    over, and the next session that records begins another."""
    global _implicit
    with _lock:
        if not _autograd_profiler._is_profiler_enabled:
            _implicit = None


def _current() -> Collection:
    global _implicit, _last
    coll = _explicit or _implicit
    if coll is not None:
        return coll
    with _lock:
        if _implicit is None:
            _implicit = _last = Collection()
        return _implicit


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "unit", "timeline", "collection", "parent", "child_s", "t0", "rf")

    def __init__(self, name: str, unit, timeline: bool):
        self.name, self.unit, self.timeline = name, unit, timeline

    def __enter__(self):
        self.collection = _current()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.child_s = 0.0
        self.rf = None
        if self.timeline and _autograd_profiler._is_profiler_enabled:
            self.rf = _autograd_profiler.record_function(
                self.name, None if self.unit is None else str(self.unit))
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.stack.pop()
        parent = self.parent
        if parent is not None:
            parent.child_s += dt
        self.collection._add(self.name, dt, dt - self.child_s,
                             parent.name if parent is not None else None,
                             threading.current_thread().name)
        return False


def span(name: str, unit=None, *, timeline: bool = True):
    """A context that times its block as the span ``name`` while tracing is
    on (see the module's docstring), and does nothing while it is off."""
    if _explicit is None and not _autograd_profiler._is_profiler_enabled:
        if _implicit is not None:
            _session_ended()
        return _NOOP
    return _Span(name, unit, timeline)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _explicit is None and not _autograd_profiler._is_profiler_enabled:
        if _implicit is not None:
            _session_ended()
        return
    _current()._count(name, n)


@contextlib.contextmanager
def collect() -> Iterator[Collection]:
    """Turn tracing on for the block, with or without a profiler, and yield
    the collection its spans and counts go to."""
    global _explicit, _last
    coll = Collection()
    with _lock:
        outer, _explicit, _last = _explicit, coll, coll
    try:
        yield coll
    finally:
        with _lock:
            _explicit = outer


def last_collection() -> Optional[Collection]:
    """The newest collection: the last ``collect()`` block's or profiler
    session's (None before any)."""
    return _last


@contextlib.contextmanager
def device_trace(logdir: Optional[str], device=None):
    """A ``torch.profiler`` trace of the block when a logdir is given: host
    activity, and CUDA activity when ``device`` is a CUDA device (default:
    when CUDA is available), with the block's spans collected. Writes a
    Chrome trace (``trace_<pid>_<n>.json``, open it in Perfetto or
    chrome://tracing) and the collection (``spans_<pid>_<n>.json``,
    ``Collection.as_dict``) into ``logdir``; yields the profiler (None
    without a logdir)."""
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with collect() as coll, profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:  # the block's kernels end inside the window
                torch.cuda.synchronize(device)
    n = len([f for f in os.listdir(logdir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))
    with open(os.path.join(logdir, f"spans_{os.getpid()}_{n}.json"), "w") as f:
        json.dump(coll.as_dict(), f, indent=1)


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
