"""Readers of the program's own spans and counters
(``voxactb_tpu_torch.utils.profiling``). The program collects them only
while a profiler records or a collection is open, so after a ``--trace 1``
run its newest collection holds the profiled slice and nothing else. Each
reader divides by the collection's own count of a root span, and returns
None where the program keeps no such collection (a program without these
spans) or the collection holds nothing it reads."""

from __future__ import annotations

from typing import Optional


def collection() -> Optional[dict]:
    """The program's newest collection as ``{"spans", "counts"}``, or None."""
    try:
        from voxactb_tpu_torch.utils import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_collection", None)
    coll = last() if last is not None else None
    return coll.as_dict() if coll is not None else None


def _calls(coll: Optional[dict], name: str) -> int:
    entry = coll["spans"].get(name) if coll else None
    return entry["calls"] if entry else 0


def ms_per_call(names, per: str) -> Optional[float]:
    """Milliseconds of the spans ``names`` together per call of the span
    ``per``."""
    coll = collection()
    calls = _calls(coll, per)
    spans = coll["spans"] if calls else {}
    if not any(n in spans for n in names):
        return None
    return 1e3 * sum(spans[n]["total_s"] for n in names if n in spans) / calls


def count_per_call(name: str, per: str) -> Optional[float]:
    """The counter ``name`` per call of the span ``per``."""
    coll = collection()
    calls = _calls(coll, per)
    if not calls or name not in coll["counts"]:
        return None
    return coll["counts"][name] / calls
