"""Host milliseconds per act turning the observation dict into the act's
arrays (language, proprio, images and clouds): the program's span
``vx.act.prep`` per ``vx.act``, over the profiled slice."""

from portbench.metrics._program import ms_per_call


def read(record):
    return ms_per_call(["vx.act.prep"], "vx.act")
