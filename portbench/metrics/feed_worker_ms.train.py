"""Milliseconds of the replay feed's worker thread per batch it produced:
drawing the batch (``vx.feed.sample``) and pinning it and issuing its copy
(``vx.feed.stage``), per ``vx.feed.stage``, over the profiled slice."""

from portbench.metrics._program import ms_per_call


def read(record):
    return ms_per_call(["vx.feed.sample", "vx.feed.stage"], "vx.feed.stage")
