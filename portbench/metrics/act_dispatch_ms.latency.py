"""Host milliseconds per act inside the act program's call (the copies to
the device, the front, the Q-network's launches and the decode, enqueued):
the program's span ``vx.act.infer`` per ``vx.act``, over the profiled
slice."""

from portbench.metrics._program import ms_per_call


def read(record):
    return ms_per_call(["vx.act.infer"], "vx.act")
