"""Blocking device-to-host copies per act: the program's counter
``act.d2h_copies`` per ``vx.act``, over the profiled slice."""

from portbench.metrics._program import count_per_call


def read(record):
    return count_per_call("act.d2h_copies", "vx.act")
