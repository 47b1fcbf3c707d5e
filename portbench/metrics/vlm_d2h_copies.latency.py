"""Blocking device-to-host copies per VLM pass: the program's counter
``vlm.d2h_copies`` per ``vx.vlm``, over the profiled slice."""

from portbench.metrics._program import count_per_call


def read(record):
    return count_per_call("vlm.d2h_copies", "vx.vlm")
