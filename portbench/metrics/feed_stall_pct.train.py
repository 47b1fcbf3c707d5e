"""Share of the replay feed's ``next()`` calls that found no batch ready:
100 x the program's counter ``feed.stalls`` over ``feed.batches``, over the
profiled slice (no stall counted reads 0)."""

from portbench.metrics._program import collection


def read(record):
    coll = collection()
    batches = coll["counts"].get("feed.batches", 0) if coll else 0
    if not batches:
        return None
    return 100.0 * coll["counts"].get("feed.stalls", 0) / batches
