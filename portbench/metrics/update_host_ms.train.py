"""Host milliseconds per update inside ``QAttentionBCAgent.update`` (the
step's dispatch, and any wait on the device inside it): the program's span
``vx.update`` per call, over the profiled slice."""

from portbench.metrics._program import ms_per_call


def read(record):
    return ms_per_call(["vx.update"], "vx.update")
